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
   every table 4 bytes past a 16-byte boundary: bit-exact against the
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
   kernel holds the stream while 50 forwards queue), twice; under PDL a
   waiting kernel's profiler record includes its wait.  No single PyTorch
   call computes these functions, so ``library_ms`` is null.
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

7. **flash attention** — the three routes of ``flash_attention`` against
   the plain version on the card, each case asserting its route from
   ``flash_attention.launches_by_route`` (D % 8 == 0 up to 256: bfloat16 on
   wgmma, float32 on tf32x3; any other D: SIMT): the reference tests' cases
   (MHA, GQA, MQA, ragged 250, causal and not, windows 16 / 64 / 1024,
   bfloat16), a ragged S = 1000, window 1024 at qwen3-1.7b's head shape, D
   12 and 6 on the SIMT route in both dtypes, and the qwen3-1.7b prefill
   shape (4, 16, 2048, 128) with Hkv 8 (in float32 also against the SIMT
   kernel on the same inputs, within the same tolerance), and for both
   tensor-core routes a grid of GQA groups 1, 2 and 8, D 16 (bfloat16) or 8
   (float32), 64, 128 and 256, S 65, 250 and 1000, causal and not, and
   windows 16, 64 and 1024; in float32 (atol 1e-5, rtol 1e-5: another
   summation order, and on tf32x3 three TF32 products a product) and
   bfloat16 (the reference's atol 3e-2 plus exactly one bfloat16 step of
   the plain output); on the wgmma route also a second gate beside it, 1e-3
   plus two bfloat16 steps of the plain output, elementwise, and a case at
   (1, 16, 32768, 128); at the prefill shape and at 32768 the gate's
   readings (largest difference over its limit, RMS ratio) of the kernel
   and of a stale-stage control (the plain version with one K/V tile
   replaced by the one two tiles before it), failing unless the gate
   rejects that control; and the inputs phase 9 gives the kernels,
   attn_apply's transposed (B, S, H, D) views at (2, 16, 64, 128) with Hkv
   8 in float32 (tf32x3) and bfloat16 and at the prefill shape in bfloat16,
   each tensor-core output checked to be a view of a (B, S, H, D) buffer;
   and phase 15's, MHA at zamba2-2.7b's head_dim 80 (32 heads) and
   olmoe-1b-7b's 128 (16 heads) at the 4 x 2048 prefill in bfloat16 and at
   2 x 64 in float32, MHA at D 80 on the grid (S 65, 250, 1000, causal or
   not, both dtypes), and both tensor-core kernels at D 80 written into the
   first 80 of 96 columns of a sentinel buffer, the 16 past them checked
   untouched (a write past column 79 would land on the next head).
8. **smoke LMs against the reference** — the qwen3-1.7b and gemma3-27b
   smoke configs with the reference's params (``lm_smoke.npz``): prefill
   logits through the kernel, teacher-forced decode logits and, at float32
   compute, the tokens of every request of the serve loop, against the
   reference's (float32 atol 1e-4 / rtol 1e-4, bfloat16 0.05, tokens
   equal); and the smoke configs of the MoE and SSM families
   (olmoe-1b-7b, qwen3-moe-235b-a22b, mamba2-370m, zamba2-2.7b) against
   ``lm_smoke_moe_ssm.npz`` the same way (a hybrid launches flash once a
   site, mamba2 never), the MoE archs at the fixture's capacity: float32
   at every position; at bfloat16 a position past 0.05 must follow, in
   its row, a position whose expert set differs from the reference's
   recorded one in some layer (:func:`lm_check_routes`; one bfloat16
   step of noise settles a near-tie of two router logits either way).
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
    kernel called directly on the same inputs (the earlier design), the
    plain version,
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
    route's at 67 TFLOP/s.  Training attention at both train cells'
    shapes ((4, 16, 8, 2048, 128) and (4, 32, 32, 2048, 224) at scale
    112^-0.5, causal; :func:`flash_train_times`): the training forward's
    output equal to the prefill kernel's bit for bit, its log-sum-exp and
    float32 output and the backward's dq, dk, dv against the float64
    plain versions of the same bfloat16 tensors (one bfloat16 step plus
    1e-4 of the largest element, and at most 2 % of a gradient's elements
    off the float64 value rounded to nearest, which rejects P and dS
    rounded to bfloat16 without their lo halves); then event and device
    times of both halves beside the backward's bound (its five products'
    causal flops at 989 TFLOP/s; x 1.6 with the split products, apart),
    the plain backward and SDPA's backward.  The records
    ``flash_attention_wgmma_forward_train`` and
    ``flash_attention_wgmma_backward`` carry these and phase 14b's
    launches.

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
13. **the quickstart, Verilog and the thesis's tables** — every launch
    counter at 0 before each part.  (a) ``repro_torch.launch.quickstart``
    as a function: model C trained 300 steps a-priori (every masked
    matmul on ``ffma``, held-out accuracy at least
    ``QUICKSTART_MIN_ACCURACY``), ``verify_tables(fused=True)`` EXACT on
    the uniform fused kernel, the level-3 artifact ``mixed`` and equal to
    the table codes, its save/load round-trip EXACT (two mixed launches,
    both ``smem``), and its Verilog.  (b) Verilog of model A compiled by
    the port at level 3 from the fixture's raw tables, of model A at
    level 4 as SOP assigns, and of model D's raw tables (10-bit case
    modules): ``RTL_ROWS`` seeded rows packed into words
    (:func:`pack_words`) through ``evaluate_verilog`` equal, bit for bit,
    the kernel the engine picks (one mixed ``smem`` launch for A, the
    per-layer kernel for D) and its plain version; the SOP form equals
    the case form on every word, and its ``netlist_sop_cost`` estimate
    lies below ``netlist_lut_cost``.  (c) ``paper_tables.timed_tables(
    quick=True)``: every row and each table's wall seconds printed;
    :func:`paper_tables.row_failures` (what the tool's own
    ``check_rows`` refuses) finds any ``ERROR`` row, an inexact Table 2.1
    or 6.1 row, and Table 7.3 sparse LUTs that change across skips; the
    masked matmul (all ``ffma``) and the per-layer kernel (each trained
    network's ``verify_tables``) must launch.  Each record carries its
    launches in (a) and (c) (``launches_quickstart``,
    ``launches_paper_tables``, each with ``_by_route``); the mixed and
    per-layer records carry (b)'s readings under ``rtl``.

14. **qwen3-1.7b trained with the LogicNet-FFN** (``python -m
    repro_torch.launch.train --full --logicnet-ffn --steps 16``: 28
    layers at the full published width, batch 8 x seq 256, AdamW lr 3e-4,
    ``LogicNetFFNCfg()``, remat "full").  (a) The masked matmul in
    bfloat16 on the wgmma route at the FFN's products, 2048 x 2048 x
    6144 and 2048 x 6144 x 2048 with the model's fan-in-16 masks, their
    input gradients on the transposed operands, M = 8192 (14c's prefill)
    and M = 4 (decode): within one bfloat16 step of the plain version plus
    1e-3 of its rms (:func:`ffn_limit`), a gate that must refuse a control
    accumulating in bfloat16 across K tiles
    (:func:`bf16_tile_accumulated`); event and device time beside
    ``torch.mm(x, w * mask)`` (``library_ms``: the FFN has no bias) and
    the bound (bytes moved once; the kept products, 2 M nnz(mask), and the
    dense ones beside it).  (f) The FFN's fused ``wi`` stage without grad
    at M = 8192 (:func:`ffn_fused_phase`): ``quant_relu`` and
    ``masked_matmul_swiglu_quant`` equal the composed path's ``xq`` and
    ``hq`` bit for bit; event and device time beside the bound, the plain
    version, the library yardstick (``torch.mm`` of the masked weights,
    ``F.silu`` and ``core.quantize``), the composed path (two wgmma masked
    matmuls and the elementwise passes) and one plain wgmma masked matmul
    on the same operands.  (b) With every launch counter at 0, the
    launcher's run: after step 1 every pruned weight of every layer's
    three FFN matrices is 0 and every mask column sums to 16; exactly 252
    masked-matmul launches a step (28 layers x (3 forward + 3 recomputed
    + 3 input gradients)), all wgmma; 56 training-attention forwards (28
    and 28 in remat's recompute), 56 backward launches (28 calls of two)
    and no prefill flash launch a step; the first 3 losses within
    ``LM_PARITY_RTOL`` of the same 3 steps with every FFN product on the
    plain version (``PlainMaskedMatmul``); host ms a step, and a
    ``torch.profiler`` trace (:func:`step_profile`, through
    :func:`trace_accepted`) of device ms a step and the idle share;
    ``max_memory_allocated``.  (c) The trained model's prefill (4 x 2048,
    without grad: 28 masked-matmul launches (``wo``), 28 of the fused
    ``wi`` stage, 28 input quantizers and 28 flash launches, all wgmma)
    and ``serve_lm.serve`` at its defaults (the same 28 + 28 + 28 a
    decode step).  (d) Checkpoint and restart at full width cut to 2
    layers: 5 steps with a checkpoint at 3 (async), a run restored from
    it (``--resume``) equal bit for bit to the file and to the live state
    saved, its losses at steps 4-5 within twice the spread of two
    uninterrupted runs; bytes written and seconds in ``save()`` against
    ``wait()``; the checkpoints in a temporary directory, removed.  (e)
    ``compress_grads_with_feedback`` on one step's gradients of that
    model: codes, scales and two steps of feedback equal the CPU's bit
    for bit.  The record ``masked_matmul_wgmma_forward`` carries 14a's
    times and 14b's launches (``launches``), 14c's (``launches_decode``)
    and the rest under ``lm_training``, ``lm_serving``, ``checkpoint``
    and ``compress``.

15. **the MoE and SSM families at full width** (``FAMILY_ARCHS``:
    olmoe-1b-7b, 16 layers, 64 experts top 8, d_ff 1024; mamba2-370m, 48
    SSM layers; zamba2-2.7b, 54 SSM layers and one shared attention
    layer at 9 sites, head_dim 80; the port's seeded init, bfloat16),
    every launch counter at 0 before each model's main path: (a) a
    4 x 2048 prefill through ``make_prefill_step``, exactly 16 / 0 / 9
    flash launches, all wgmma, finite logits; (b) ``serve_lm.serve`` at
    its defaults, every request served, olmoe's dropped (token, k) pairs
    a decode step at its own capacity printed; the counters read, and set
    to 0 again for the checks: (c) for olmoe the three dispatches layer
    by layer on the dense prefill's own hidden states (``sorted_local``
    against ``dense`` at capacity 1.25, drops counted; ``sorted`` against
    both at capacity E / k = 8.0; the 0.05 contract) and the
    ``sorted_local`` prefill end to end beside dense's (reported with the
    positions whose expert sets differ); 2 prompts of 64 tokens decoded
    one at a time against one prefill at every position
    (:func:`family_decode_check`; olmoe at capacity 8.0 with 0 drops):
    float32 within 1e-4 (olmoe) or ``SSM_DECODE_TOL`` (SSM stacks); for
    olmoe at bfloat16 the 0.05 contract on all but 1e-4 of the logits,
    routers free at the positions whose expert sets agree with prefill's
    (at least ``MOE_BF16_MIN_HELD``), and routers pinned to prefill's
    choices at every position, with phase 9b's rule at each row's last
    position; (d) the prefill and a decode step profiled
    (:func:`step_profile`: host against device ms, the idle share,
    kernels by kind), ``max_memory_allocated``; then flash at
    (4, 32, 2048, 80) and (4, 16, 2048, 128) MHA causal bfloat16: event
    and device time beside SDPA, the plain version and the bound.  The
    flash record carries each model's main-path launches
    (``launches_moe``, ``launches_hybrid``, ``launches_ssm``), the checks'
    apart (``launches_moe_checks``, ...), and the phase under
    ``lm_families``.

17. **the families trained** (the wgmma masked matmul on the LogicNet
    paths; the others launch no kernel of the repo: a MoE layer takes
    ``moe`` before the LogicNet-FFN, mamba2 has no FFN, whisper's layers
    call the dense FFN, and training attention takes ``attn_train_route``'s
    path: the flash kernels for bfloat16 where the chunked form computes
    the true function, else the chunked form, as the reference's).  (a) Every run of ``lm_smoke_train.npz``
    (:func:`train_runs`: the ten zoo archs at smoke size, and qwen3-1.7b,
    zamba2-2.7b and qwen2-vl-2b with ``LogicNetFFNCfg()``) at float32
    and bfloat16 compute: the reference's init carried in with
    ``from_reference``, the step-0 gradient norm and 5 AdamW steps on the
    card (:func:`train_five_steps`), held by :func:`train_check` to the
    CPU tests' gates (losses rtol 1e-3, the norm 1e-5 / 0.05, final
    float32 parameters 1e-5 but for the eps-conditioned elements, masks
    and pruned weights; a MoE bfloat16 step past its gate only at or
    after a step whose expert sets differ from the record's); a LogicNet
    run's 6 masked products a layer and pass on ``ffma`` (float32) or
    ``wgmma`` (bfloat16).  (b) ``FT_FULL``: olmoe-1b-7b (cut to 8
    layers: 16 are 111 GB of float32 states), mamba2-370m, zamba2-2.7b
    and qwen2-vl-2b with the LogicNet-FFN, whisper-medium, at full width
    through ``train.build`` and ``loop.run`` at the launcher's defaults
    (qwen2-vl's vision embeddings seeded, :func:`seeded_vision`),
    every launch counter at 0 first and each state freed before the next:
    the LogicNet runs' first 3 losses within ``LM_PARITY_RTOL`` of the
    plain version's, their masks held after step 1 and exactly
    :func:`masked_matmul_per_step` launches a step (81 and 252), all
    wgmma; olmoe's dropped (token, k) pairs a step; finite losses, the
    ``[train]`` line, host ms over steps 4-6, :func:`step_profile` (2
    measured steps) and ``max_memory_allocated``; no checkpoint.  (c) 14a's check and times
    at zamba2's (2048 x 2560 x 10240) and qwen2-vl's (8192 x 1536 x
    8960) FFN products and their input gradients.  The wgmma record
    carries the launches (``launches_train_zamba2``,
    ``launches_train_qwen2_vl``, ``launches_train_smoke_by_route``), (c)
    under ``shapes_train_*`` and the rest under ``train_families``.

18. **the mesh path on a (1, 1) mesh** (:func:`mesh_phases`): training,
    a prefill and ``serve`` bit for bit the unsharded path's, and the
    dry-run's qwen3-1.7b cells on both production meshes.

19. **the work spread as the reference spreads it** (:func:`ep_tp_phases`;
    the card is one, so the spread runs over repeated or one-rank
    devices).  (a) Model A level 3 served by a tier on ``TIER_DEVICES``
    (two replicas of ``cuda:0``) and by one on one device, on 64 ragged
    requests: codes bit for bit ``net(codes)``'s, ``sharded``, no build
    or compiler run after warmup, each replica's launches by route (one
    ``smem`` launch a shard), wall s in turns.  (b) olmoe-1b-7b, a 4 x
    2048 prefill unsharded and then on a (1, 1) NCCL mesh through the
    expert-parallel dispatch: logits and every layer's kept (token, k)
    pairs bit for bit, 16 wgmma flash launches.  (c) mamba2-370m the
    same way through the head-parallel block, prefill and 8 greedy
    decode steps: logits, tokens and the final SSD state and conv ring
    bit for bit.  (d) The dry-run's olmoe-1b-7b and mamba2-370m x
    train_4k cells at 16x16: ``ok``, TFLOP and collective GB a device
    beside the readings with the weights gathered whole.  The mixed LUT
    record carries 19a's launches (``launches_tier_replicas``,
    ``..._by_replica``), the flash record 19b's (``launches_ep_mesh``),
    and the phase is under the mixed record's ``spread``.

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

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()   # the script's start, for its total
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


def measured_run(records, spin_end) -> tuple[list, list]:
    """``(runs, the measured run)`` of a :func:`device_ms` trace: its
    kernel records (time ranges sorted by start, the spin kernel's left
    out) split into runs by device-side gaps of 10 ms or more, and the
    first run that starts after the spin kernel ends (``spin_end``, None
    when the trace lost that record): the measured calls queue behind the
    spin kernel, the ``LEAD_CALLS`` calls run before it.  Without a spin
    record, the longest run."""
    runs = [[]]
    for r in records:
        if runs[-1] and r.start - runs[-1][-1].end >= 1e4:
            runs.append([])
        runs[-1].append(r)
    after = [run for run in runs
             if run and spin_end is not None and run[0].start >= spin_end]
    return runs, after[0] if after else max(runs, key=len)


def device_ms(fn, iters: int, launches: int = 1, tries: int = 5,
              device_bound: bool = False) -> float | None:
    """Device time per call of ``fn``, which launches ``launches`` kernels a
    call, from a trace of ``iters`` calls between ``LEAD_CALLS`` calls
    before them and one after them, each group 20 ms apart on the host.
    The kernel records fall into runs split by device-side gaps of 10 ms
    or more; the measured calls' run is the one after the spin kernel
    (:func:`measured_run`).  CUDA events around
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
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        spins = [e.time_range.end for e in kernels
                 if "spin_kernel" in e.name]
        records = sorted((e.time_range for e in kernels
                          if "spin_kernel" not in e.name),
                         key=lambda r: r.start)
        runs, measured = measured_run(records, spins[0] if spins else None)
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
    """Seeded (B, H, S, D) q, k and v; ``s`` is a length, or (Sq, Skv) for
    cross-attention.  With ``bshd`` they are transposed views of
    (B, S, H, D) tensors, as ``attn_apply`` and ``cross_attn_apply`` pass
    them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    sq, skv = s if isinstance(s, tuple) else (s, s)
    if bshd:
        return [torch.randn(shape, generator=g, device=dev).to(dt)
                .transpose(1, 2)
                for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                              (b, skv, hkv, d))]
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                          (b, hkv, skv, d))]


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
    # phase 15's: zamba2-2.7b's shared attention (MHA at head_dim 80, the
    # tensor-core kernels padding D to 128 and 96) and olmoe-1b-7b's (MHA
    # at 128: one head a block), bfloat16 at the 4 x 2048 prefill, float32
    # at the 2 x 64 decode check's
    cases += [((PREFILL_SHAPE[0], h, h, PREFILL_SHAPE[1], d), "bfloat16",
               dict(causal=True), True) for h, d in ((32, 80), (16, 128))]
    cases += [((b, h, h, s, d), "float32", dict(causal=True), True)
              for h, d in ((32, 80), (16, 128))]
    # phase 16's: whisper-medium's encoder (1500 frames, non-causal),
    # decoder and cross-attention (448 tokens or one decode token against
    # the 1500 frames: Sq != Skv) at MHA 16 x 64, and qwen2-vl-2b's GQA
    # 12 / 2 at head_dim 128, as the main path gives them, then at the
    # 2 x 64 float32 decode check's shapes
    bb = PREFILL_SHAPE[0]
    cases += [((bb, 16, 16, 1500, 64), "float32", dict(causal=False), True),
              ((bb, 16, 16, (WHISPER_TEXT, 1500), 64), "float32",
               dict(causal=False), True),
              ((bb, 16, 16, WHISPER_TEXT, 64), "bfloat16",
               dict(causal=True), True),
              ((bb, 16, 16, (1, 1500), 64), "bfloat16", dict(causal=False),
               True),
              ((bb, 12, 2, PREFILL_SHAPE[1], 128), "bfloat16",
               dict(causal=True), True),
              ((b, 16, 16, 1500, 64), "float32", dict(causal=False), True),
              ((b, 16, 16, (s, 1500), 64), "float32", dict(causal=False),
               True),
              ((b, 16, 16, s, 64), "float32", dict(causal=True), True),
              ((b, 16, 16, (1, 1500), 64), "float32", dict(causal=False),
               True),
              ((b, 12, 2, s, 128), "float32", dict(causal=True), True)]
    n_named = len(cases)
    # Sq != Skv on every route (non-causal, no window): one query, a ragged
    # tile on either side, more queries than keys; SIMT at D 12 and 6
    cases += [((1, hq, hkv, lens, d), dt, dict(causal=False), False)
              for dt in ("bfloat16", "float32") for d in (64, 128)
              for hq, hkv in ((4, 4), (4, 2))
              for lens in ((1, 1500), (65, 250), (WHISPER_TEXT, 1500),
                           (250, 65), (1, 1))]
    cases += [((1, 4, 2, lens, d), dt, dict(causal=False), False)
              for dt in ("bfloat16", "float32") for d in (12, 6)
              for lens in ((1, 250), (65, 1000), (300, 70))]
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
    # MHA at head_dim 80 (zamba2-2.7b), both tensor-core routes
    cases += [((1, 32, 32, s, 80), dt, dict(causal=c), False)
              for s in (65, 250, 1000) for c in (True, False)
              for dt in ("bfloat16", "float32")]
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
            simt = flash_simt(torch, q, k, v)
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
    guard = flash_column_guard(torch, dev)
    log(f"phase 7 flash_attention: {len(cases)} cases within tolerance "
        f"({by_route['wgmma']} on the wgmma route, {by_route['tf32x3']} on "
        f"the tf32x3 route, {by_route['simt']} on the SIMT route; the last "
        f"{len(cases) - n_named}: GQA 1/2/8, D 8-256, MHA at D 80, S "
        f"65/250/1000, windows 16/64/1024, causal or not, Sq != Skv "
        f"(1-448 queries against 1-1500 keys, non-causal) on all three "
        f"routes, in bfloat16 and float32); "
        f"largest difference float32 {errs['float32']:.3g}, bfloat16 "
        f"{errs['bfloat16']:.3g}, by route {route_errs}; wgmma cases within "
        f"{gate_worst:.3g} of the second gate (atol {FA_GATE[0]} + "
        f"{FA_GATE[2]} bfloat16 steps)")
    return {"max_abs_err": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "max_abs_err_by_route": route_errs,
            "gate_worst_ratio": gate_worst, "column_guard": guard,
            **gate_controls(torch, dev)}


def flash_column_guard(torch, dev) -> dict:
    """Phase 7: the tensor-core kernels at head_dim 80 (zamba2-2.7b's) pad D
    to 128 inside the kernel, reading columns past 80 as zeros.  Each is
    launched into the first 80 columns of a (B, S, H, 96) buffer full of a
    sentinel (q, k and v the transposed (B, S, H, 80) views the model
    passes): the 16 columns past 79, where a write past the head would
    land on the next head's first columns in the model's (B, S, H, 80)
    buffer, must keep the sentinel bit for bit, and the 80 within
    tolerance of the plain version."""
    from repro_torch.kernels import flash_attention as FA
    out = {}
    b, h, s, d, wide = 2, 32, 250, 80, 96
    for dtype, launch in (("bfloat16", FA._launch_wgmma),
                          ("float32", FA._launch_tf32)):
        q, k, v = flash_inputs(torch, dev, b, h, h, s, d, dtype, seed=7,
                               bshd=True)
        buf = torch.full((b, s, h, wide), -7.25, dtype=q.dtype, device=dev)
        launch(q, k, v, buf[..., :d].transpose(1, 2), True, None,
               1.0 / d ** 0.5)
        want = FA.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        if not bool((buf[..., d:] == -7.25).all()):
            fail(f"flash_attention {dtype} at D {d}: the kernel wrote past "
                 f"column {d - 1} of a head")
        got = buf[..., :d].transpose(1, 2)
        diff = (got.float() - want.float()).abs()
        if bool((diff > mm_limit(torch, want, *FA_TOL[dtype])).any()):
            fail(f"flash_attention {dtype} at D {d} into a strided buffer: "
                 f"max |kernel - plain| {float(diff.max())}")
        out[dtype] = float(diff.max())
    log(f"phase 7 flash_attention at (B, Hq, Hkv, S, D) ({b}, {h}, {h}, "
        f"{s}, {d}) into the first {d} of {wide} columns: the {wide - d} "
        f"past them untouched on both tensor-core routes, max |kernel - "
        f"plain| {out}")
    return out


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
    version: the kernel; and a stale-stage control, the plain
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


# -- MoE router choices: recorded, compared, pinned (phases 8 and 15) -----

@contextlib.contextmanager
def record_routing():
    """While active, every call of the port's MoE router appends
    ``{"topi": (..., K)}`` (its top-k experts, detached) to the list this
    yields, in call order: layer by layer, and a decode step by step."""
    from repro_torch.models import moe
    rec: list[dict] = []
    inner = moe._router

    def router(p, x, cfg):
        topi, weights, aux = inner(p, x, cfg)
        rec.append({"topi": topi.detach()})
        return topi, weights, aux

    moe._router = router
    try:
        yield rec
    finally:
        moe._router = inner


@contextlib.contextmanager
def pin_routing(choices):
    """While active, the port's MoE router takes each call's experts from
    ``choices`` (one integer tensor a call, in call order, reshaped to the
    call's (..., K)) in place of its own top-k, and weighs them by the
    softmax of its own logits there (its aux loss is its own): two runs
    under the same choices differ only in arithmetic.  Every choice must
    be used."""
    import torch

    from repro_torch.models import moe
    inner = moe._router
    todo = iter(choices)

    def router(p, x, cfg):
        aux = inner(p, x, cfg)[2]
        topi = torch.as_tensor(next(todo), device=x.device).long().reshape(
            *x.shape[:-1], cfg.moe.top_k)
        logits = x.float() @ p["router"].float()
        return topi, torch.softmax(logits.gather(-1, topi), dim=-1), aux

    moe._router = router
    try:
        yield
        if next(todo, None) is not None:
            fail("pin_routing: the run made fewer router calls than it was "
                 "given choices for")
    finally:
        moe._router = inner


def route_sets(routes, shape) -> list:
    """Each recorded call's chosen experts, sorted, as numpy (*shape, K)."""
    return [r["topi"].sort(-1).values.reshape(*shape, -1).cpu().numpy()
            for r in routes]


def fixture_route_sets(topi) -> list:
    """A fixture's router choices (layers, B, S, K) as :func:`route_sets`
    of a run (one sorted (B, S, K) array a layer)."""
    import numpy as np
    return list(np.sort(np.asarray(topi), axis=-1))


def routes_differ(a, b) -> "np.ndarray":
    """(B, S) bool: positions whose expert set differs in any layer between
    two runs' ``route_sets`` (layer by layer)."""
    import numpy as np
    if len(a) != len(b):
        fail(f"the runs recorded {len(a)} and {len(b)} router calls")
    out = np.zeros(a[0].shape[:2], bool) if a else None
    for x, y in zip(a, b):
        out |= (x != y).any(-1)
    return out


def decode_routes(routes, n_layers: int, rows: int, steps: int) -> list:
    """A teacher-forced decode's router calls (step by step, every layer)
    as one (rows, steps, K) array a layer, the prefill's layout."""
    import numpy as np
    per = route_sets(routes, (rows, 1))
    return [np.concatenate(per[i::n_layers], axis=1)
            for i in range(n_layers)]


def at_or_after(marked) -> "np.ndarray":
    """(B, S) bool: the positions at or after a marked one in their row
    (a token that attends to a marked one)."""
    import numpy as np
    return np.maximum.accumulate(np.asarray(marked, bool), axis=1)


def lm_check_routes(name, got, want, dtype, differ) -> float:
    """``lm_check`` for logits (B, S, V) of a MoE model held against the
    reference's: at float32 every position; at bfloat16, where one rounding
    step upstream can settle a near-tie of two router logits the other way,
    a position past the contract must follow, at or before it in its row,
    a position whose expert set differs from the reference's in some layer
    (``differ``, (B, S), :func:`routes_differ`): its own token or one it
    attends to went through other experts.  Returns the largest difference
    over the positions no such difference precedes."""
    import numpy as np
    if dtype == "float32":
        return lm_check(name, got, want, dtype)
    got = got.float().cpu().numpy()
    atol, rtol = LM_TOL[dtype]
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{name}: {got.shape} vs {want.shape} or not finite")
    diff = np.abs(got - want)
    bad = (diff > atol + rtol * np.abs(want)).any(-1)
    explained = at_or_after(differ)
    if (bad & ~explained).any():
        fail(f"{name}: {int(bad.sum())} of {bad.size} positions beyond atol "
             f"{atol} rtol {rtol} (max {float(diff.max())}), "
             f"{int((bad & ~explained).sum())} with the reference's experts "
             f"at and before them")
    return float(diff[~explained].max()) if (~explained).any() else 0.0


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


def moe_ssm_smoke_phase(torch, dev) -> dict:
    """Phase 8, the MoE and SSM families: their smoke configs with the
    reference's params against the reference's outputs
    (``lm_smoke_moe_ssm.npz``), each run at the fixture's MoE capacity;
    float32 at every position, and at bfloat16 a MoE model's positions
    past the contract each after a router choice that differs from the
    reference's recorded one (:func:`lm_check_routes`)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve_lm
    from repro_torch.models import model as M

    with np.load(FIXTURE / "lm_smoke_moe_ssm.npz") as z:
        fx = {k: z[k] for k in z.files}
    out = {}
    for arch in ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
                 "zamba2-2.7b"):
        pre = f"{arch}.params."
        arrays = {k[len(pre):]: v for k, v in fx.items()
                  if k.startswith(pre)}
        tokens = torch.from_numpy(fx[f"{arch}.tokens"]).to(dev)
        for cd in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype=cd)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(
                        fx[f"{arch}.{cd}.capacity_factor"])))
            model = M.from_reference(cfg, arrays, device=dev)
            before = flash_attention.launches
            with record_routing() as routes:
                logits = M.forward(model, {"tokens": tokens})
            torch.cuda.synchronize()
            if flash_attention.launches - before != attention_layers(cfg):
                fail(f"{arch} {cd} prefill launched flash_attention "
                     f"{flash_attention.launches - before} times, not "
                     f"{attention_layers(cfg)}")
            want = fx[f"{arch}.{cd}.decode"]
            b, n = want.shape[:2]
            differ = {"prefill": np.zeros(tokens.shape, bool),
                      "decode": np.zeros((b, n), bool)}
            if cfg.moe is not None:
                differ["prefill"] = routes_differ(
                    route_sets(routes, tokens.shape),
                    fixture_route_sets(fx[f"{arch}.{cd}.prefill_topi"]))
            e_pre = lm_check_routes(f"{arch} {cd} prefill", logits,
                                    fx[f"{arch}.{cd}.prefill"], cd,
                                    differ["prefill"])
            cache = M.init_cache(cfg, b, n, device=dev)
            cache = {k: v.to(getattr(torch, cd))
                     if k in ("k", "v", "shared_k", "shared_v") else v
                     for k, v in cache.items()}
            steps = []
            with record_routing() as routes:
                for t in range(n):
                    lg, cache = M.decode_step(
                        model, cache, tokens[:, t:t + 1],
                        torch.full((b,), t, dtype=torch.int32, device=dev))
                    steps.append(lg[:, 0])
            if cfg.moe is not None:
                differ["decode"] = routes_differ(
                    decode_routes(routes, cfg.n_layers, b, n),
                    fixture_route_sets(fx[f"{arch}.{cd}.decode_topi"]))
            e_dec = lm_check_routes(f"{arch} {cd} decode",
                                    torch.stack(steps, 1), want, cd,
                                    differ["decode"])
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
                f"{LM_TOL[cd][0]}; expert set other than the reference's "
                f"at {int(differ['prefill'].sum())} of {tokens.numel()} "
                f"prefill and {int(differ['decode'].sum())} of {b * n} "
                f"decode positions){msg}")
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
    n_params = sum(p.numel() for p in model.params.values())
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
               model.params)
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


def sdpa(q, k, v, causal: bool = True):
    """``F.scaled_dot_product_attention(is_causal=causal, enable_gqa=True)``
    held to its fused backends, so it never builds the (S x S) scores."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
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


def flash_simt(torch, q, k, v):
    """The SIMT kernel (the earlier design) called directly, causal,
    bypassing the route rule (and the launch counts): timed beside the
    kernel in the same run."""
    from repro_torch.kernels import flash_attention as FA
    out = torch.empty_like(q)
    FA._launch_simt(q, k, v, out, True, None, 1.0 / q.shape[-1] ** 0.5)
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
        dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           5, device_bound=True)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=True),
                           iters, reps)
        library_ms = cuda_ms(lambda: sdpa(q, k, v), iters, reps)
        simt_ms = cuda_ms(lambda: flash_simt(torch, q, k, v), 1,
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
                    f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                    f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                          else "operations"),
                    f"shape{suffix}": [b, 16, 8, s, 128]})
        log(f"phase 10 flash_attention_forward (B, Hq, Hkv, S, D) "
            f"({b}, 16, 8, {s}, 128) bfloat16 causal (wgmma): {ms:.4f} "
            f"ms/call, device {dev_ms} ms (back to back), plain "
            f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
            f"({ms / library_ms:.2f}x), the SIMT kernel {simt_ms:.4f} ms, "
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
    simt_ms = cuda_ms(lambda: flash_simt(torch, q, k, v), 3, 5)
    simt_dev = device_ms(lambda: flash_simt(torch, q, k, v), 3,
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


# the two train cells' attention (B, Hq, Hkv, S, D, scale): qwen3-1.7b's
# layers and zamba2-7b's shared blocks
TRAIN_ATTN_SHAPES = (((4, 16, 8, 2048, 128), None),
                     ((4, 32, 32, 2048, 224), 112 ** -0.5))
# training attention against the float64 plain versions of the same
# bfloat16 inputs, as tests/test_torch_cuda.py holds it: each gradient
# within one bfloat16 step plus TRAIN_GRAD_REL of its largest element, at
# most TRAIN_ROUNDED_SHARE of its elements other than the float64 value
# rounded to nearest bfloat16 (a plain emulation of the kernels reads
# 0.22-0.29 % with P and dS split into hi + lo halves, 41-42 % with them
# rounded once), the log-sum-exp within TRAIN_LSE_ATOL and the float32
# output within TRAIN_O32_TOL (atol, rtol)
TRAIN_GRAD_REL = 1e-4
TRAIN_ROUNDED_SHARE = 0.02
TRAIN_LSE_ATOL = 2e-5
TRAIN_O32_TOL = (1e-5, 1e-5)
# the hi + lo split runs each of P V (forward), P^T dO, dS K and dS^T Q
# twice: the backward's five products cost 1.6 times their own work
BWD_SPLIT_FACTOR = 1.6
FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma_bwd.cu"
# the reference trains through XLA (its Pallas kernel has no backward)
FA_TRAIN_REFERENCE = "src/repro/models/attention.py:59"


def flash_train_check(torch, q, k, v, do, scale) -> dict:
    """Training attention on the card against the float64 plain versions
    on the same bfloat16 card tensors: the training forward's output equal
    to the prefill kernel's bit for bit, its log-sum-exp and float32
    output, and dq, dk, dv of the backward (through ``FlashAttentionFn``)
    within the TRAIN_* gates; the readings, or :func:`fail`."""
    from repro_torch.kernels import flash_attention as FA
    out, lse, o32 = FA._train_forward(q, k, v, True, scale)
    if not torch.equal(out, FA.flash_attention(q, k, v, causal=True,
                                               scale=scale)):
        fail("phase 10 the training forward's output is not the prefill "
             "kernel's bit for bit")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_train(*leaves, causal=True, scale=scale).backward(do)
    grads = [t.grad for t in leaves]
    del leaves
    f64 = [t.double() for t in (q, k, v, do)]
    _, lse64, o64 = FA.flash_attention_train_plain(*f64[:3], scale=scale)
    lse_err = float((lse.double() - lse64).abs().max())
    o32_excess = float(((o32.double() - o64).abs() - TRAIN_O32_TOL[0]
                        - TRAIN_O32_TOL[1] * o64.abs()).max())
    want = FA.flash_attention_backward_plain(*f64[:3], o64, lse64, f64[3],
                                             scale=scale)
    del f64, lse64, o64, lse, o32
    rec = {"lse_max_abs_err": lse_err}
    if not lse_err <= TRAIN_LSE_ATOL or not o32_excess <= 0:
        fail(f"phase 10 training forward: lse off by {lse_err} (gate "
             f"{TRAIN_LSE_ATOL}), float32 output {o32_excess} past "
             f"{TRAIN_O32_TOL}")
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        top = float(w.abs().max())
        _, e = torch.frexp(w.float())
        ulp = torch.ldexp(torch.full_like(w, 2.0 ** -8), e)
        diff = (got.double() - w).abs()
        excess = float((diff - TRAIN_GRAD_REL * top - ulp).max())
        share = float((got != w.to(torch.bfloat16)).double().mean())
        rec[name] = {"max_rel_err": float(diff.max()) / top,
                     "rounded_share": share}
        if not (excess <= 0 and share <= TRAIN_ROUNDED_SHARE):
            fail(f"phase 10 backward {name}: {excess} past one bfloat16 "
                 f"step plus {TRAIN_GRAD_REL} of {top}, or {share} of its "
                 f"elements off the float64 value rounded (gate "
                 f"{TRAIN_ROUNDED_SHARE})")
    return rec


def flash_train_times(torch, dev) -> dict:
    """Phase 10, training attention: at both train cells' shapes, causal,
    the checks of :func:`flash_train_check`, then the training forward
    (``flash_attention_wgmma_forward_train``) and the backward (its two
    launches, ``flash_attention_wgmma_backward``): event and device times
    beside the bound of the backward's own work (5 products of
    2·B·Hq·S²·D/2 causal flops at 989 TFLOP/s, as row 5's forward bound
    counts P V once; ``bwd_split_bound_ms`` is it × 1.6, the three
    products split into hi + lo run twice), the plain backward and
    SDPA's backward (the library yardstick, where a fused backend takes
    the shape)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as FA
    rec = {}
    for (b, hq, hkv, s, d), scale in TRAIN_ATTN_SHAPES:
        sc = scale or d ** -0.5
        q, k, v = flash_inputs(torch, dev, b, hq, hkv, s, d, "bfloat16")
        do = flash_inputs(torch, dev, b, hq, hq, s, d, "bfloat16",
                          seed=1)[0]
        key = f"_{d}"
        rec[f"train_check{key}"] = flash_train_check(torch, q, k, v, do, sc)
        torch.cuda.empty_cache()
        _, lse, o32 = FA._train_forward(q, k, v, True, sc)

        def fwd():
            return FA._train_forward(q, k, v, True, sc)

        def bwd():
            return FA.flash_attention_backward(q, k, v, o32, lse, do,
                                               causal=True, scale=sc)

        fwd_ms, bwd_ms = cuda_ms(fwd, 5), cuda_ms(bwd, 5)
        fwd_dev = device_ms(fwd, 5, device_bound=True)
        bwd_dev = device_ms(bwd, 5, launches=2, device_bound=True)
        plain_ms = cuda_ms(lambda: FA.flash_attention_backward_plain(
            q, k, v, o32, lse, do, causal=True, scale=sc), 1, 3)
        try:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                y = F.scaled_dot_product_attention(
                    *leaves, is_causal=True, scale=sc, enable_gqa=True)
                library_ms = cuda_ms(lambda: torch.autograd.grad(
                    y, leaves, do, retain_graph=True), 5)
            del y, leaves
        except RuntimeError as err:       # no fused backend for the shape
            library_ms = None
            log(f"phase 10 SDPA backward at D {d}: {str(err)[:120]}")
        ops = 5 * 2 * b * hq * s * s * d // 2
        bound_ms = ops / FLOPS_PER_S["bfloat16"] * 1e3
        rec.update({f"train_fwd_ms{key}": fwd_ms,
                    f"train_fwd_device_ms{key}": fwd_dev,
                    f"bwd_ms{key}": bwd_ms, f"bwd_device_ms{key}": bwd_dev,
                    f"bwd_plain_ms{key}": plain_ms,
                    f"bwd_library_ms{key}": library_ms,
                    f"bwd_bound_ms{key}": bound_ms,
                    f"bwd_split_bound_ms{key}": bound_ms * BWD_SPLIT_FACTOR,
                    f"train_shape{key}": [b, hq, hkv, s, d]})
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"phase 10 flash_attention_wgmma_backward (B, Hq, Hkv, S, D) "
            f"({b}, {hq}, {hkv}, {s}, {d}) causal: checks "
            f"{rec[f'train_check{key}']}; {bwd_ms:.4f} ms/call "
            f"(2 launches), device {bwd_dev} ms, bound {bound_ms:.5f} ms "
            f"({ops / bwd_ms / 1e9:.1f} TFLOP/s of the function's work; "
            f"x {BWD_SPLIT_FACTOR} with the split products "
            f"{bound_ms * BWD_SPLIT_FACTOR:.5f} ms), plain "
            f"{plain_ms:.4f} ms, SDPA backward {lib}; training forward "
            f"{fwd_ms:.4f} ms, device {fwd_dev} ms")
        del q, k, v, do, lse, o32
        torch.cuda.empty_cache()
    return rec


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


# -- phase 13: the quickstart, RTL against the kernels, the thesis's tables

RTL_ROWS = 64
# the wrappers whose launches phase 13 reads, by their kernels line's names
PHASE13_WRAPPERS = ("lut_mixed_forward", "lut_uniform_forward",
                    "lut_layer_forward", "masked_matmul_ffma_forward")
QUICKSTART_MIN_ACCURACY = 0.8


def pack_words(codes, bw: int) -> list:
    """Each row of (rows, features) integer codes as the netlist's input
    word: feature f's code at bits [bw * f, bw * (f + 1))."""
    return [sum(int(c) << (bw * f) for f, c in enumerate(row))
            for row in codes]


def unpack_word(word: int, bw: int, n_out: int) -> list:
    """An output word as its ``n_out`` codes of ``bw`` bits, LSB first."""
    return [(word >> (bw * j)) & ((1 << bw) - 1) for j in range(n_out)]


def phase13_launches(wrappers) -> dict:
    """Each wrapper's launches and launches by route, by kernel name."""
    return {name: {"launches": w.launches,
                   "by_route": dict(w.launches_by_route)}
            for name, w in zip(PHASE13_WRAPPERS, wrappers)}


def launched_only(launches: dict) -> dict:
    """The kernels of a ``phase13_launches`` record that launched."""
    return {k: v for k, v in launches.items() if v["launches"]}


def quickstart_phase(torch, dev, wrappers) -> dict:
    """Phase 13a: ``repro_torch.launch.quickstart`` on the card."""
    from repro_torch.launch import quickstart

    for w in wrappers:
        reset_counts(w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = quickstart.run(device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = phase13_launches(wrappers)
    mixed, uniform, layer, mm = (launches[n] for n in PHASE13_WRAPPERS)
    if not (out["verify_exact"] and out["roundtrip_exact"]
            and out["layout"] == "mixed"
            and out["accuracy"] >= QUICKSTART_MIN_ACCURACY):
        fail(f"phase 13a quickstart: {out}")
    # verify_tables(fused=True) on the uniform kernel; the artifact and its
    # reloaded copy on the mixed one; every training step on ffma
    if (uniform["launches"] != 1 or uniform["by_route"]["smem"] != 1
            or mixed["launches"] != 2 or mixed["by_route"]["smem"] != 2
            or mm["launches"] < quickstart.STEPS
            or mm["by_route"]["ffma"] != mm["launches"]
            or layer["launches"]):
        fail(f"phase 13a quickstart launches {launches}")
    log(f"phase 13a quickstart (model C, {quickstart.STEPS} steps, a-priori) "
        f"in {secs:.2f} s: accuracy {out['accuracy']:.4f}; "
        f"verify_tables(fused=True) EXACT on the uniform fused kernel; "
        f"artifact layout {out['layout']} ({out['table_slab_bytes']} B of "
        f"table slab, raw {out['raw_table_bytes']} B), round-trip "
        f"({out['npz_bytes']} B npz) EXACT; {out['modules']} Verilog "
        f"modules, {out['verilog_bytes'] / 1e3:.1f} kB; launches "
        f"{launched_only(launches)}")
    return {**out, "seconds": secs, "launches": launches}


def rtl_phase(torch, dev, triples, triples_d, wrappers) -> dict:
    """Phase 13b: Verilog of models A (level 3, and level 4 as SOP) and D
    (raw) evaluated word by word against the kernel the engine picks and
    the plain version, on ``RTL_ROWS`` seeded rows."""
    import numpy as np

    from repro_torch import compile as rcompile
    from repro_torch import engine
    from repro_torch.core import lut_cost as LC
    from repro_torch.core import verilog as V
    from repro_torch.core.netlist import build_netlist
    from repro_torch.kernels.lut_lookup import lut_lookup_plain
    from repro_torch.kernels.lut_network import lut_network_mixed_plain

    rng = np.random.default_rng(13)
    out = {}
    t0 = time.perf_counter()
    res = {lv: rcompile.optimize(rcompile.tables_from_triples(triples), lv,
                                 in_features=16) for lv in (3, 4)}
    opt_s = time.perf_counter() - t0
    raw_d = rcompile.tables_from_triples(triples_d)
    cases = (("A@L3", res[3].netlist, res[3], False, 3),
             ("A@L4-sop", res[4].netlist, res[4], True, 3),
             ("D-raw", build_netlist(raw_d, 16), triples_d, False, 2))
    for name, nl, layers, sop, bw in cases:
        codes_np = rng.integers(0, 1 << bw, (RTL_ROWS, 16), dtype=np.int32)
        codes = torch.from_numpy(codes_np).to(dev)
        net = engine.compile_network(layers, in_features=16, device=dev)
        want_layout = "per_layer" if name == "D-raw" else "mixed"
        for w in wrappers:
            reset_counts(w)
        got = net(codes)
        torch.cuda.synchronize()
        launched = phase13_launches(wrappers)
        if net.layout == "mixed":
            plain = lut_network_mixed_plain(codes, net.slabs)
            route_ok = launched["lut_mixed_forward"]["by_route"] == {
                "smem": 1, "global": 0}
        else:
            plain = codes
            for idx, tab, b in net.layers:
                plain = lut_lookup_plain(plain, idx, tab, b)
            route_ok = (launched["lut_layer_forward"]["launches"]
                        == len(net.layers))
        if net.layout != want_layout or not route_ok:
            fail(f"phase 13b {name}: layout {net.layout}, launches "
                 f"{launched}")
        t0 = time.perf_counter()
        files = V.generate_verilog(nl, sop=sop)
        gen_s = time.perf_counter() - t0
        forms = {"rtl": files}
        if sop:
            forms["rtl_case"] = V.generate_verilog(nl)
            if not any("assign M1[" in t for t in files.values()):
                fail(f"phase 13b {name}: no SOP module emitted")
        n_layers, last = len(nl.layers), nl.layers[-1]
        t0 = time.perf_counter()
        rtl = {k: np.array([unpack_word(V.evaluate_verilog(f, w, n_layers),
                                        last[0].out_bits, len(last))
                            for w in pack_words(codes_np, bw)])
               for k, f in forms.items()}
        eval_s = time.perf_counter() - t0
        got_np, plain_np = got.cpu().numpy(), plain.cpu().numpy()
        for k, r in rtl.items():
            if not (np.array_equal(r, got_np) and np.array_equal(r, plain_np)):
                fail(f"phase 13b {name}: {k} differs from the kernel on "
                     f"{int((r != got_np).any(1).sum())} of {RTL_ROWS} rows "
                     f"and from the plain version on "
                     f"{int((r != plain_np).any(1).sum())}")
        bound = LC.netlist_lut_cost(nl)
        sop_cost = LC.netlist_sop_cost(nl)
        if sop and not sop_cost["est_kluts"] < bound:
            fail(f"phase 13b {name}: SOP estimate {sop_cost} not below the "
                 f"bound {bound}")
        n_bytes = sum(map(len, files.values()))
        log(f"phase 13b {name}: {len(files)} Verilog modules, {n_bytes} B "
            f"(generate_verilog {gen_s:.3f} s host); {RTL_ROWS} words "
            f"through evaluate_verilog ({' and '.join(forms)}, {eval_s:.2f} s "
            f"host) == {net.layout} kernel ({launched_only(launched)}) == "
            f"plain, bit for "
            f"bit; netlist_lut_cost {bound}, netlist_sop_cost est_kluts "
            f"{sop_cost['est_kluts']} ({sop_cost['covered_neurons']} "
            f"covered, {sop_cost['fallback_neurons']} at the bound)")
        out[name] = {"layout": net.layout, "modules": len(files),
                     "verilog_bytes": n_bytes, "generate_s": gen_s,
                     "evaluate_s": eval_s, "netlist_lut_cost": bound,
                     "est_kluts": sop_cost["est_kluts"],
                     "launches": launched_only(launched)}
    out["optimize_s"] = opt_s
    return out


def tables_phase(torch, dev, wrappers) -> dict:
    """Phase 13c: ``all_tables(quick=True)`` on the card."""
    from repro_torch.launch import paper_tables

    for w in wrappers:
        reset_counts(w)
    t0 = time.perf_counter()
    rows, walls = paper_tables.timed_tables(quick=True, device=dev)
    secs = time.perf_counter() - t0
    launches = phase13_launches(wrappers)
    for name, us, derived in rows:
        log(f"phase 13c {name} {us:.1f} us {derived}")
    log(f"phase 13c wall s a table: "
        + " ".join(f"{n}={s:.2f}" for n, s in walls.items())
        + f"; all {secs:.2f} s (budgets {paper_tables.BUDGETS[True]})")
    bad = paper_tables.row_failures(rows)
    mm, layer = launches["masked_matmul_ffma_forward"], launches[
        "lut_layer_forward"]
    if (not mm["launches"] or mm["by_route"]["ffma"] != mm["launches"]
            or not layer["launches"]):
        bad.append(f"launches {launches}")
    if bad:
        fail("phase 13c: " + "; ".join(bad))
    log(f"phase 13c: no ERROR row, Table 2.1 and 6.1 exact, Table 7.3's "
        f"sparse LUTs equal across skips; launches "
        f"{launched_only(launches)}")
    return {"rows": len(rows), "walls": walls, "seconds": secs,
            "launches": launches}


# -- phase 14: qwen3-1.7b trained with the LogicNet-FFN -------------------
# the launcher's flags for 14b (its defaults otherwise: batch 8 x seq 256,
# lr 3e-4, LogicNetFFNCfg(), remat "full")
LM_TRAIN_STEPS = 16
# steps 1-3 are checked (masks, launches, parity), 4-6 warm the caching
# allocator, 7-9 are timed on the host clock, 10-16 traced by step_profile
# (3 lead, 3 measured, 1 after; a trace that loses records is taken again,
# and its steps run past the schedule's end at its floor lr)
LM_HOST_STEPS = (6, 9)
LM_PROFILE_LEAD = 3
# the spin kernel that opens each profiled step (about 0.1 ms)
MARKER_CYCLES = 200_000
# 14b's first steps against the same steps with every FFN product on the
# plain version (torch float32 products of the same bfloat16 operands).
# The two differ in summation order only: on an H100 the three losses
# read bit for bit equal under one init and 7.24e-5 apart under another
# (most sums of 16 kept products of a 16-level input and a bfloat16
# weight are exact in float32), so the limit is 1e-3, 14x the larger
LM_PARITY_STEPS = 3
LM_PARITY_RTOL = 1e-3
# 9 masked products a layer and step: 3 forward, 3 recomputed by remat,
# 3 input gradients; 3 a layer and decode step
LM_MM_PER_LAYER_STEP = 9
# without grad a LogicNet-FFN launches one masked matmul (wo), one fused wi
# stage and one input quantizer
LM_MM_PER_LAYER_DECODE = 1
# 14d: the depth cut to 2 layers at full width (a 28-layer state is about
# 29 GB of float32 parameters, moments and masks on disk; 2 layers about
# 5.5 GB), 5 steps, a checkpoint at step 3
CKPT_LAYERS = 2
CKPT_STEPS = 5
CKPT_EVERY = 3
# 14a: the FFN's products as (name, M, mask) at batch 8 x seq 256 (M
# 2048), at 14c's prefill of 4 x 2048 tokens (M 8192) and at 4 decode
# slots: mask_in (2048, 6144) for wi_gate and wi_up, mask_out (6144, 2048)
# for wo; the input gradients ("dx") read the transposed weight and mask
FFN_CASES = (("wi", 2048, "in"), ("wo", 2048, "out"),
             ("dx_wi", 2048, "in_t"), ("dx_wo", 2048, "out_t"),
             ("wi_prefill", PREFILL_SHAPE[0] * PREFILL_SHAPE[1], "in"),
             ("wo_prefill", PREFILL_SHAPE[0] * PREFILL_SHAPE[1], "out"),
             ("wi_m4", 4, "in"), ("wo_m4", 4, "out"))
# 14a's gate, set from the outputs' own scale: FFN_STEPS bfloat16 steps
# of the plain output plus FFN_ATOL_SHARE of its rms.  Kernel and plain
# version round one float32 sum of the same 16 (or about 48 or 5, for the
# transposed masks) kept products, taken in another order, so they land
# at most one step apart; the float32 sums themselves differ by about
# 1e-6 of the rms.  MM_TOL's atol 5e-2 is as large as these outputs (rms
# 0.05-0.09), so it would pass a kernel that accumulates in bfloat16:
# the control below (FFN_CONTROL_TILE) must fail this gate
FFN_ATOL_SHARE = 1e-3
FFN_STEPS = 1
# the control: x @ (w * mask) with the accumulator rounded to bfloat16
# after each K tile of the wgmma kernel's depth (64)
FFN_CONTROL_TILE = 64


def lm_train_args(ckpt_dir: str, steps: int, ckpt_every: int = 1000,
                  resume: bool = False):
    """``launch.train``'s flags for phase 14: ``--full --logicnet-ffn``."""
    from repro_torch.launch import train
    return train.parse_args(["--full", "--logicnet-ffn", "--steps",
                             str(steps), "--ckpt-dir", ckpt_dir,
                             "--ckpt-every", str(ckpt_every)]
                            + ["--resume"] * resume)


def all_wrappers():
    """Every kernel wrapper of the port (each has a launch count)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_train)
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import lut_network, lut_network_mixed
    from repro_torch.kernels.masked_matmul import (
        masked_matmul, masked_matmul_swiglu_quant, quant_relu)
    return (lut_network_mixed, lut_network, lut_lookup, masked_matmul,
            masked_matmul_swiglu_quant, quant_relu, flash_attention,
            flash_attention_train, flash_attention_backward)


def reset_all() -> None:
    for w in all_wrappers():
        reset_counts(w)


def bits_of(t):
    """A tensor's bits (floats as same-width integers), for equality bit
    for bit."""
    import torch
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def fingerprint(torch, tree) -> list:
    """Per leaf, the int64 sum of its bits: equal trees give equal lists."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        else:
            out.append(int(bits_of(t).sum(dtype=torch.int64)))
    walk(tree)
    return out


def ffn_limit(torch, want):
    """14a's elementwise limit for a bfloat16 output ``want`` of the plain
    version: FFN_STEPS steps of ``want`` plus FFN_ATOL_SHARE of its rms."""
    rms = float(want.float().square().mean().sqrt())
    return mm_limit(torch, want, FFN_ATOL_SHARE * rms, 0.0, FFN_STEPS)


def bf16_tile_accumulated(torch, x, w, mask, tile: int = FFN_CONTROL_TILE):
    """The control for 14a's gate: ``x @ (w * mask)`` summed in float32
    within each K tile of ``tile`` and accumulated across tiles in
    bfloat16 (a kernel that keeps its accumulator in bfloat16 between K
    tiles)."""
    xf, wm = x.float(), (w * mask).float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.bfloat16,
                      device=x.device)
    for k0 in range(0, x.shape[1], tile):
        acc = (acc.float() + xf[:, k0:k0 + tile] @ wm[k0:k0 + tile]
               ).bfloat16()
    return acc


def ffn_masked_matmul_phase(torch, dev, d_model: int = 2048,
                            d_ff: int = 6144, cases=FFN_CASES,
                            tag: str = "14a") -> dict:
    """Phase 14a (and 17c at other widths): the wgmma masked matmul at a
    LogicNet-FFN's shapes (``d_model`` x ``d_ff``, its fan-in-16 masks;
    ``cases`` as ``FFN_CASES``) against its plain version, timed beside
    ``torch.mm(x, w * mask)`` and the bound."""
    from repro_torch.kernels.masked_matmul import (masked_matmul,
                                                   masked_matmul_plain)
    from repro_torch.models.config import LogicNetFFNCfg
    from repro_torch.models.layers import logicnet_masks

    mask_in, mask_out = (m.to(device=dev, dtype=torch.bfloat16)
                         for m in logicnet_masks(d_model, d_ff,
                                                 LogicNetFFNCfg()))
    masks = {"in": mask_in, "out": mask_out,
             "in_t": mask_in.t().contiguous(),
             "out_t": mask_out.t().contiguous()}
    rec, err, control = {}, 0.0, {}
    for i, (name, m, which) in enumerate(cases):
        mask = masks[which]
        k, n = mask.shape
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5
             ).bfloat16()
        before = dict(masked_matmul.launches_by_route)
        got = masked_matmul(x, w, mask)
        want = masked_matmul_plain(x, w, mask)
        torch.cuda.synchronize()
        if masked_matmul.launches_by_route["wgmma"] != before["wgmma"] + 1:
            fail(f"phase {tag} masked_matmul {name} {m}x{k}x{n}: not one "
                 f"wgmma launch ({masked_matmul.launches_by_route})")
        limit = ffn_limit(torch, want)
        diff = (got.float() - want.float()).abs()
        share = float((diff / limit).max())
        if share > 1:
            fail(f"phase {tag} masked_matmul {name} {m}x{k}x{n}: max |kernel "
                 f"- plain| {float(diff.max())}, {share:.3g} of the limit "
                 f"({FFN_STEPS} bfloat16 step + {FFN_ATOL_SHARE} of the "
                 f"output's rms)")
        err = max(err, float(diff.max()))
        bad = (bf16_tile_accumulated(torch, x, w, mask).float()
               - want.float()).abs() > limit
        control[name] = int(bad.sum())
        if not control[name]:
            fail(f"phase {tag} masked_matmul {name} {m}x{k}x{n}: the gate "
                 f"passes the control that accumulates in bfloat16")
        rms = float(want.float().square().mean().sqrt())
        big = m > 4
        iters = 20 if big else 200
        ms = cuda_ms(lambda: masked_matmul(x, w, mask), iters)
        plain_ms = cuda_ms(lambda: masked_matmul_plain(x, w, mask), iters)
        library_ms = cuda_ms(lambda: torch.mm(x, w * mask), iters)
        dev_ms = device_ms(lambda: masked_matmul(x, w, mask), iters,
                           device_bound=big)
        moved = nbytes(x, w, mask) + m * n * x.element_size()
        ops = 2 * m * int(mask.count_nonzero())
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S["bfloat16"] * 1e3
        sfx = "" if name == "wi" else f"_{name}"
        rec.update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                    f"device_ms{sfx}": dev_ms,
                    f"library_ms{sfx}": library_ms,
                    f"bound_ms{sfx}": max(bytes_ms, ops_ms),
                    f"bound_by{sfx}": ("bytes" if bytes_ms >= ops_ms
                                       else "operations"),
                    f"bound_ms_dense{sfx}": max(
                        bytes_ms, 2 * m * k * n / FLOPS_PER_S["bfloat16"]
                        * 1e3),
                    f"shape{sfx}": [m, k, n],
                    f"limit_share{sfx}": share,
                    f"control_beyond{sfx}": control[name]})
        log(f"phase {tag} masked_matmul {name} {m}x{k}x{n} bfloat16 (wgmma, "
            f"fan-in-16 mask): max |kernel - plain| {float(diff.max()):.3g}, "
            f"{share:.3g} of the limit (output rms {rms:.4g}); the "
            f"bfloat16-accumulating control beyond it at {control[name]} "
            f"of {m * n} outputs; "
            f"{ms:.5f} ms/call, device {dev_ms} ms, plain {plain_ms:.5f} ms, "
            f"torch.mm(x, w * mask) {library_ms:.5f} ms "
            f"({ms / library_ms:.2f}x), bound {max(bytes_ms, ops_ms):.6f} ms "
            f"({moved} B, {ops} flop of kept products; dense products "
            f"{rec[f'bound_ms_dense{sfx}']:.6f} ms)")
    rec["max_abs_err"] = err
    return rec


def ffn_fused_phase(torch, dev, d_model: int = 2048, d_ff: int = 6144,
                    m: int = PREFILL_SHAPE[0] * PREFILL_SHAPE[1],
                    iters: int = 20) -> dict:
    """Phase 14f: the LogicNet-FFN's ``wi`` stage without grad at the LM
    prefill's M, fused (``quant_relu``, then
    ``masked_matmul_swiglu_quant``) against the composed path (the
    quantizers of ``core.quantize``, two wgmma masked matmuls, ``F.silu``
    and the product): ``xq`` and ``hq`` bit for bit, then event and device
    time of each kernel beside its bound, its plain version, the library
    yardstick and the composed steps it replaces, and one plain wgmma
    masked matmul on the same operands (row 4's kernel, unchanged)."""
    import torch.nn.functional as F

    from repro_torch.core.quantize import QuantizerCfg, quantize
    from repro_torch.kernels import masked_matmul as MM
    from repro_torch.models.config import LogicNetFFNCfg
    from repro_torch.models.layers import logicnet_masks

    cfg = LogicNetFFNCfg()
    q = QuantizerCfg(cfg.bw, cfg.max_val)
    mask = logicnet_masks(d_model, d_ff, cfg)[0].to(dev, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(300)
    x = (torch.randn((m, d_model), generator=g, device=dev) * 1.5).bfloat16()
    wg, wu = ((torch.randn((d_model, d_ff), generator=g, device=dev) * 0.5
               ).bfloat16() for _ in range(2))

    def quant_composed(v):
        return quantize(q, v.float()).value.to(v.dtype)

    def wi_composed(xq):
        return quant_composed(F.silu(MM.masked_matmul(xq, wg, mask))
                              * MM.masked_matmul(xq, wu, mask))

    def wi_fused(xq):
        return MM.masked_matmul_swiglu_quant(xq, wg, wu, mask, q)

    def wi_library(xq):
        return quant_composed(F.silu(torch.mm(xq, wg * mask))
                              * torch.mm(xq, wu * mask))

    before = (MM.quant_relu.launches,
              MM.masked_matmul_swiglu_quant.launches_by_route["wgmma"])
    xq = MM.quant_relu(x, q)
    hq = wi_fused(xq)
    torch.cuda.synchronize()
    if (MM.quant_relu.launches,
            MM.masked_matmul_swiglu_quant.launches_by_route["wgmma"]) != (
            before[0] + 1, before[1] + 1):
        fail("phase 14f: the fused wi stage did not launch its two kernels")
    bits = {}
    for name, got, want in (("xq", xq, quant_composed(x)),
                            ("hq", hq, wi_composed(xq))):
        bits[name] = int((got.view(torch.int16)
                          != want.view(torch.int16)).sum())
        if bits[name]:
            fail(f"phase 14f: the fused {name} differs from the composed "
                 f"path's at {bits[name]} of {want.numel()} elements")
    nnz = int(mask.count_nonzero())
    times: dict = {}

    def timed(f):
        if f not in times:
            times[f] = cuda_ms(f, iters)
        return times[f]

    def quant_plain():
        return MM.quant_relu_plain(x, q)

    rec = {"shape": [m, d_model, d_ff], "bits_differ": bits,
           "levels": torch.bincount(torch.round(
               hq.float() / q.step).long().flatten()).tolist()}
    for name, fn, plain, library, composed, moved, ops, dense in (
            ("wi", lambda: wi_fused(xq),
             lambda: MM.masked_matmul_swiglu_quant_plain(xq, wg, wu, mask,
                                                         q),
             lambda: wi_library(xq), lambda: wi_composed(xq),
             nbytes(xq, wg, wu, mask) + m * d_ff * 2, 4 * m * nnz,
             4 * m * d_model * d_ff),
            # the quantizer's plain version is the composed path's, and no
            # other library call computes it: one timing serves all three
            ("quant", lambda: MM.quant_relu(x, q), quant_plain, quant_plain,
             quant_plain, 2 * nbytes(x), 0, 0)):
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S["bfloat16"] * 1e3
        r = {"ms": cuda_ms(fn, iters),
             "device_ms": device_ms(fn, iters, device_bound=name == "wi"),
             "plain_ms": timed(plain), "library_ms": timed(library),
             "composed_ms": timed(composed),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bound_ms_dense": max(bytes_ms, dense / FLOPS_PER_S[
                 "bfloat16"] * 1e3)}
        rec[name] = r
        log(f"phase 14f {name} {m}x{d_model}x{d_ff}: {r['ms']:.5f} ms/call, "
            f"device {r['device_ms']} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}; dense products {r['bound_ms_dense']:.6f}), "
            f"plain {r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} "
            f"ms, composed path {r['composed_ms']:.5f} ms "
            f"({r['composed_ms'] / r['ms']:.2f}x); bit for bit the "
            f"composed path's")
    one = {"ms": cuda_ms(lambda: MM.masked_matmul(xq, wg, mask), iters),
           "device_ms": device_ms(lambda: MM.masked_matmul(xq, wg, mask),
                                  iters, device_bound=True)}
    rec["masked_matmul_wgmma"] = one
    log(f"phase 14f masked_matmul_wgmma {m}x{d_model}x{d_ff} on the same "
        f"operands: {one['ms']:.5f} ms/call, device {one['device_ms']} ms; "
        f"hq levels {rec['levels']}")
    return rec


class PlainMaskedMatmul:
    """``MaskedMatmulFn``'s stand-in for the parity run: the plain version
    under autograd (torch float32 products of the same operands)."""

    @staticmethod
    def apply(x, w, mask, b=None):
        from repro_torch.kernels.masked_matmul import masked_matmul_plain
        return masked_matmul_plain(x, w, mask, b)


def step_profile(torch, fn, iters: int = 3, lead: int = 2,
                 tries: int = 3) -> dict:
    """Host, event and device ms a call of ``fn`` (a training step) from
    one ``torch.profiler`` trace: ``lead`` calls, then ``iters`` measured
    calls, each synchronised and each opened by a short spin kernel
    (``torch.cuda._sleep``, its record a marker, not counted), a last
    marker, then one more call.  A step's device time is the sum of the
    kernel records between its marker and the next: a step can hold a
    device gap of 10 ms or more (the caching allocator freeing and
    allocating between backward and the optimizer), so gaps cannot
    delimit it.  The reading stands when all ``iters + 1`` markers are in
    the trace and :func:`trace_accepted` takes it: every measured step
    holds as many records as the largest (a lost record shows as a
    shorter step).  The step's time is the host's or the device's,
    whichever is slower, so the event-time floor for device-bound calls
    is not applied.  The run fails when no trace of ``tries`` stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        host, event = [], []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                fn()
            torch.cuda.synchronize()
            for _ in range(iters):
                torch.cuda._sleep(MARKER_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                event.append(start.elapsed_time(end))
            torch.cuda._sleep(MARKER_CYCLES)
            fn()
            torch.cuda.synchronize()
        records = sorted(((e.time_range, e.name) for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and not e.is_user_annotation),
                         key=lambda r: r[0].start)
        marks = [i for i, (_, name) in enumerate(records)
                 if "spin_kernel" in name]
        if len(marks) != iters + 1:
            log(f"step_profile: {len(marks)} of {iters + 1} markers in the "
                f"trace ({len(records)} records); tracing again")
            continue
        measured = [records[a + 1:b] for a, b in zip(marks, marks[1:])]
        per = [len(run) for run in measured]
        dev_ms = [sum(r.elapsed_us() for r, _ in run) / 1e3
                  for run in measured]
        dev = statistics.mean(dev_ms)
        ev = statistics.mean(event)
        if trace_accepted(sum(per), iters * max(per), dev, ev,
                          device_bound=False):
            h = statistics.mean(host)
            by_name: dict[str, float] = {}
            for run in measured:
                for r, name in run:
                    by_name[name] = (by_name.get(name, 0.0)
                                     + r.elapsed_us() / 1e3 / iters)
            return {"host_ms": h, "event_ms": ev, "device_ms": dev,
                    "idle_share": 1 - dev / h, "kernels_per_step": max(per),
                    "host_ms_each": host, "device_ms_each": dev_ms,
                    "device_ms_by_kind": kernel_kinds(by_name),
                    "top_kernels": "; ".join(
                        f"{k[:160]} {v:.3f}" for k, v in sorted(
                            by_name.items(), key=lambda kv: -kv[1])[:8]),
                    "top_gemm_kernels": top_kernels(
                        {k: v for k, v in by_name.items()
                         if any(g in k.lower() for g in GEMM_NAMES)}, 4)}
        log(f"step_profile: kernel records a measured step {per}; tracing "
            f"again")
    fail(f"step_profile: no trace of {tries} accepted")


GEMM_NAMES = ("gemm", "gemv", "cutlass", "cublas", "nvjet", "xmma")


def kernel_kinds(by_name: dict) -> dict:
    """Device ms a step by kind of kernel: the masked matmul, the other
    matrix products (cuBLAS / CUTLASS: attention projections, the LM head,
    weight gradients; on Hopper cuBLAS names many of its kernels
    ``nvjet_*``), copies and fills, and the rest (elementwise and
    reductions: AdamW, norms, quantizers, softmax)."""
    kinds = {"masked_matmul": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "masked_matmul" in low:
            kind = "masked_matmul"
        elif any(k in low for k in GEMM_NAMES):
            kind = "gemm"
        elif "memcpy" in low or "memset" in low:
            kind = "copy"
        else:
            kind = "other"
        kinds[kind] += ms
    return kinds


def adamw_timed(torch, run_steps) -> dict:
    """Run ``run_steps`` with ``launch.steps``' AdamW update bracketed:
    host ms to issue it (its Python loop over the leaves) and the span of
    the device's timeline between CUDA events around it, means a step.
    The train step reads the loss before AdamW, so the device is idle
    when the update starts: its span is the issue time or the kernels'
    time, whichever is longer."""
    from repro_torch.launch import steps as steps_mod
    real = steps_mod.adamw_update
    spans = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        try:
            return real(*args, **kwargs)
        finally:
            end.record()
            spans.append((time.perf_counter() - t0, start, end))

    steps_mod.adamw_update = timed
    try:
        run_steps()
    finally:
        steps_mod.adamw_update = real
    torch.cuda.synchronize()
    return {"host_ms": 1e3 * statistics.mean(h for h, _, _ in spans),
            "device_span_ms": statistics.mean(a.elapsed_time(b)
                                              for _, a, b in spans),
            "steps": len(spans)}


def lm_train_phase(torch, dev, tmp: str) -> dict:
    """Phase 14b: ``launch.train --full --logicnet-ffn`` on the card."""
    import gc

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.masked_matmul import masked_matmul
    from repro_torch.launch import steps, train
    from repro_torch.models import layers as model_layers

    args = lm_train_args(tmp, LM_TRAIN_STEPS)
    # the parity run first: the same flags, every FFN product on the plain
    # version, LM_PARITY_STEPS steps
    model_layers.MaskedMatmulFn = PlainMaskedMatmul
    try:
        reset_all()
        plain = train.build(args)
        plain.loop.run(plain.batches, LM_PARITY_STEPS)
        plain_losses = [l for _, l in plain.loop.metrics]
        if masked_matmul.launches:
            fail(f"phase 14b parity run launched masked_matmul "
                 f"{masked_matmul.launches} times")
    finally:
        from repro_torch.kernels.masked_matmul import MaskedMatmulFn
        model_layers.MaskedMatmulFn = MaskedMatmulFn
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    # the main path of this slice: every launch counter at 0
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, loop = run.cfg, run.loop
    n_params = sum(p.numel() for p in loop.state["params"].values())
    n_masks = sum(p.numel() for n, p in loop.state["params"].items()
                  if "mask" in n)
    per_step = LM_MM_PER_LAYER_STEP * cfg.n_layers
    loop.run(run.batches, 1)
    if masked_matmul.launches != per_step:
        fail(f"phase 14b step 1 launched masked_matmul "
             f"{masked_matmul.launches} times, not {per_step}")
    p = loop.state["params"]
    for i in range(cfg.n_layers):
        for wname, mname in (("wi_gate", "mask_in"), ("wi_up", "mask_in"),
                             ("wo", "mask_out")):
            w, m = p[f"layers.{i}.ffn.{wname}"], p[f"layers.{i}.ffn.{mname}"]
            if bool((w[m == 0] != 0).any()) or bool(
                    (m.sum(0) != cfg.logicnet_ffn.fan_in).any()):
                fail(f"phase 14b layer {i} {wname}: a pruned weight is not "
                     f"0 after step 1, or a mask column does not sum to "
                     f"{cfg.logicnet_ffn.fan_in}")
    loop.run(run.batches, LM_PARITY_STEPS)
    losses = [l for _, l in loop.metrics]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    if not rel <= LM_PARITY_RTOL:
        fail(f"phase 14b losses {losses} against the plain version's "
             f"{plain_losses}: rtol {rel} beyond {LM_PARITY_RTOL}")
    log(f"phase 14b {cfg.arch_id} --full --logicnet-ffn: {cfg.n_layers} "
        f"layers, {n_params} float32 parameters ({n_masks} of them masks), "
        f"state built in {build_s:.2f} s; step 1 launched masked_matmul "
        f"{per_step} times, pruned weights 0 and every mask column "
        f"{cfg.logicnet_ffn.fan_in} after it; losses {losses} against "
        f"{plain_losses} with every FFN product on the plain version "
        f"(max rtol {rel:.3g}, limit {LM_PARITY_RTOL})")
    loop.run(run.batches, LM_HOST_STEPS[0])
    adamw = adamw_timed(torch, lambda: loop.run(run.batches,
                                                LM_HOST_STEPS[1]))
    host_ms = 1e3 * statistics.mean(run.step_s[LM_HOST_STEPS[0]:
                                                LM_HOST_STEPS[1]])
    prof = step_profile(torch, lambda: loop.run(run.batches, loop.step + 1),
                        lead=LM_PROFILE_LEAD)
    loop.run(run.batches, LM_TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps_run = loop.step
    launches = masked_matmul.launches
    by_route = dict(masked_matmul.launches_by_route)
    losses = [l for _, l in loop.metrics]
    if (launches != per_step * steps_run or by_route["wgmma"] != launches):
        fail(f"phase 14b: {launches} masked_matmul launches in {steps_run} "
             f"steps ({by_route}); expected {per_step} a step, all wgmma")
    # training attention: a forward a layer, again in remat's recompute
    # (non-reentrant checkpointing runs the first forward with grad), and
    # a backward call of two launches a layer; no prefill launch
    attn = {"forward": (FA.flash_attention_train.launches,
                        dict(FA.flash_attention_train.launches_by_route)),
            "backward": (FA.flash_attention_backward.launches,
                         dict(FA.flash_attention_backward.launches_by_route)),
            "prefill": FA.flash_attention.launches}
    remat = 2 if cfg.remat != "none" else 1
    if (attn["forward"][0] != remat * cfg.n_layers * steps_run
            or attn["backward"][0] != 2 * cfg.n_layers * steps_run
            or attn["prefill"]):
        fail(f"phase 14b: training attention launched {attn} in "
             f"{steps_run} steps; expected {remat * cfg.n_layers} forwards "
             f"and {2 * cfg.n_layers} backward launches a step, no prefill")
    if len(losses) != steps_run or not all(
            l == l and abs(l) < float("inf") for l in losses):
        fail(f"phase 14b: losses {losses}")
    line = train.summary(run)
    print(line, flush=True)
    log(f"phase 14b {steps_run} steps: masked_matmul {launches} launches "
        f"({launches / steps_run:.0f} a step, by route {by_route}); "
        f"training attention {attn}; "
        f"{host_ms:.3f} ms a step on the host clock (synchronised, steps "
        f"{LM_HOST_STEPS[0] + 1}-{LM_HOST_STEPS[1]}), of which AdamW "
        f"{adamw['host_ms']:.3f} ms to issue its kernels and "
        f"{adamw['device_span_ms']:.3f} ms of the device's timeline; "
        f"profiled steps "
        f"(host ms, CUDA-event ms, device ms, idle share, kernels a step): "
        f"{prof}; peak {peak / 1e9:.3f} GB allocated "
        f"({torch.cuda.get_device_name(0)})")
    model = steps.model_from_state(cfg, loop.state)
    out = {"launches": launches, "launches_by_route": by_route,
           "attn_launches": attn,
           "steps": steps_run, "losses": losses,
           "plain_losses": plain_losses, "parity_rtol": rel,
           "step_ms": host_ms, "adamw": adamw, "profile": prof,
           "peak_bytes": peak,
           "n_params": n_params, "n_mask_params": n_masks,
           "train_line": line}
    del run, loop, p
    gc.collect()
    torch.cuda.empty_cache()
    return out, cfg, model


def lm_trained_serving_phase(torch, dev, cfg, model) -> dict:
    """Phase 14c: the trained model's prefill and the decode loop."""
    import numpy as np

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.masked_matmul import (
        masked_matmul, masked_matmul_swiglu_quant, quant_relu)
    from repro_torch.launch import serve_lm, steps

    def fused_counts():
        return (masked_matmul_swiglu_quant.launches_by_route["wgmma"],
                quant_relu.launches)

    b, s = PREFILL_SHAPE
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    reset_all()
    logits = steps.make_prefill_step(cfg)(model, {"tokens": tokens})
    torch.cuda.synchronize()
    per_fwd = LM_MM_PER_LAYER_DECODE * cfg.n_layers
    if (masked_matmul.launches != per_fwd
            or masked_matmul.launches_by_route["wgmma"] != per_fwd
            or fused_counts() != (cfg.n_layers, cfg.n_layers)
            or flash_attention.launches_by_route["wgmma"] != cfg.n_layers):
        fail(f"phase 14c prefill: masked_matmul "
             f"{masked_matmul.launches_by_route}, fused wi and input "
             f"quantizer {fused_counts()}, flash "
             f"{flash_attention.launches_by_route}")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"phase 14c prefill logits {tuple(logits.shape)} not finite")
    reset_all()
    res = serve_lm.serve(cfg, model)
    torch.cuda.synchronize()
    mm = masked_matmul.launches
    if (len(res.done) != 12 or mm != per_fwd * res.steps
            or masked_matmul.launches_by_route["wgmma"] != mm
            or fused_counts() != (mm, mm)):
        fail(f"phase 14c decode: {len(res.done)} of 12 requests, masked_"
             f"matmul {masked_matmul.launches_by_route}, fused wi and "
             f"input quantizer {fused_counts()} in {res.steps} steps "
             f"(expected {per_fwd} of each a step, all wgmma)")
    log(f"phase 14c trained model: prefill {b} x {s} tokens launched "
        f"masked_matmul {per_fwd} times, the fused wi stage and the input "
        f"quantizer {cfg.n_layers} each and flash {cfg.n_layers} (all "
        f"wgmma), finite logits; served {len(res.done)} requests, "
        f"{res.tokens} tokens in {res.steps} decode steps "
        f"({1e3 * res.seconds / res.steps:.3f} ms a step), masked_matmul "
        f"{mm} launches ({mm / res.steps:.0f} a decode step, all wgmma); "
        f"first request's tokens {res.done[0]['out'][:8]}")
    return {"launches_prefill": per_fwd, "launches_decode": mm,
            "decode_steps": res.steps, "tokens": res.tokens,
            "decode_ms": 1e3 * res.seconds / res.steps}


def lm_checkpoint_phase(torch, dev, root: str) -> dict:
    """Phase 14d: checkpoint and restart at full width, 2 layers."""
    import dataclasses
    import gc

    from repro_torch.checkpoint import latest_step, load_arrays
    from repro_torch.launch import train

    def build(tag, ckpt_every, resume=False):
        d = os.path.join(root, tag)
        args = lm_train_args(d, CKPT_STEPS, ckpt_every, resume)
        cfg = dataclasses.replace(train.config(args), n_layers=CKPT_LAYERS)
        return d, train.build(args, cfg)

    # A: 5 steps, a checkpoint at 3, the save and the wait timed
    dir_a, a = build("a", CKPT_EVERY)
    mgr, spent = a.loop.mgr, {"save": 0.0, "wait": 0.0}
    real = {"save": mgr.save, "wait": mgr.wait}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    mgr.save, mgr.wait = timed("save"), timed("wait")
    saved = {}
    step_fn = a.loop.step_fn

    def watched(state, batch):
        out = step_fn(state, batch)
        if a.loop.step + 1 == CKPT_EVERY:       # the state the loop saves
            saved["fp"] = fingerprint(torch, {"state": state})
        return out

    a.loop.step_fn = watched
    a.loop.run(a.batches, CKPT_STEPS)
    losses_a = [l for _, l in a.loop.metrics]
    path = os.path.join(dir_a, f"step_{CKPT_EVERY:08d}.npz")
    if latest_step(dir_a) != CKPT_EVERY:
        fail(f"phase 14d: latest checkpoint {latest_step(dir_a)}")
    written = os.path.getsize(path)
    del a
    gc.collect()
    torch.cuda.empty_cache()

    # B: a fresh run restored at step 3 (``--resume``), to step 5
    t0 = time.perf_counter()
    _, b = build("a", CKPT_EVERY, resume=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if b.loop.step != CKPT_EVERY:
        fail(f"phase 14d: restored at step {b.loop.step}")
    if fingerprint(torch, {"state": b.loop.state}) != saved["fp"]:
        fail("phase 14d: the restored state differs from the state saved "
             "at step 3")
    stored, _ = load_arrays(path)
    state = b.loop.state
    restored = {f"['state']['{part}'][{name!r}]": t
                for part, tree in (("params", state["params"]),)
                for name, t in tree.items()}
    restored.update({f"['state']['opt']['{mv}'][{name!r}]": t
                     for mv in ("m", "v")
                     for name, t in state["opt"][mv].items()})
    restored["['state']['opt']['step']"] = state["opt"]["step"]
    if sorted(restored) != sorted(k for k in stored if k != "['step']") \
            or int(stored["['step']"]) != CKPT_EVERY:
        fail("phase 14d: the file's leaves are not the train state's")
    for leaf_path, t in restored.items():
        if t.detach().cpu().numpy().tobytes() != stored[leaf_path].tobytes():
            fail(f"phase 14d: restored {leaf_path} differs from the file")
    del stored, restored, state
    b.loop.run(b.batches, CKPT_STEPS)
    resumed = [l for _, l in b.loop.metrics]
    del b
    gc.collect()
    torch.cuda.empty_cache()

    # C: the same 5 steps again, uninterrupted and unsaved: the spread of
    # two uninterrupted runs sets the tolerance of the resumed losses
    _, c = build("c", 1000)
    c.loop.run(c.batches, CKPT_STEPS)
    losses_c = [l for _, l in c.loop.metrics]
    spread = max(abs(x - y) for x, y in zip(losses_a, losses_c))
    tol = 2 * spread + 1e-6 * max(abs(x) for x in losses_a)
    miss = max(abs(x - y) for x, y in zip(resumed, losses_a[CKPT_EVERY:]))
    if miss > tol:
        fail(f"phase 14d: resumed losses {resumed} against "
             f"{losses_a[CKPT_EVERY:]}: {miss} beyond {tol} (twice the "
             f"spread {spread} of two uninterrupted runs, plus 1e-6)")
    log(f"phase 14d checkpoint at full width, {CKPT_LAYERS} layers: "
        f"{written} B written at step {CKPT_EVERY}; save() {spent['save']:.3f}"
        f" s (host snapshot), wait() {spent['wait']:.3f} s (the write's "
        f"rest after steps {CKPT_EVERY + 1}-{CKPT_STEPS}); restored in "
        f"{restore_s:.3f} s (fresh state included) bit for bit equal to the "
        f"file and to the live state saved; losses {losses_a}, resumed "
        f"{resumed} (max diff {miss:.3g}, tolerance {tol:.3g}; two "
        f"uninterrupted runs differ by {spread:.3g})")
    return {"bytes": written, "save_s": spent["save"],
            "wait_s": spent["wait"], "restore_s": restore_s,
            "losses": losses_a, "resumed": resumed, "spread": spread,
            "tolerance": tol}, c


def compress_phase(torch, dev, run) -> dict:
    """Phase 14e: int8 compression of one step's gradients (14d's 2-layer
    model) on the card against the CPU on the same gradients."""
    from repro_torch.models import model as M
    from repro_torch.optim import (compress_grads_with_feedback,
                                   compress_int8, init_error_state)
    params = run.loop.state["params"]
    loss = M.loss_fn(params, run.cfg, run.batches(run.loop.step))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    cpu = {k: g.cpu() for k, g in grads.items()}
    codes = 0
    for k in grads:
        q, s = compress_int8(grads[k])
        qc, sc = compress_int8(cpu[k])
        if not (torch.equal(q.cpu(), qc) and torch.equal(bits_of(s.cpu()),
                                                         bits_of(sc))):
            fail(f"phase 14e compress_int8 {k}: codes or scale differ "
                 f"between the card and the CPU")
        codes += q.numel()
    err, err_c = init_error_state(grads), init_error_state(cpu)
    for _ in range(2):
        deq, err = compress_grads_with_feedback(grads, err)
        deq_c, err_c = compress_grads_with_feedback(cpu, err_c)
        for k in grads:
            if not (torch.equal(bits_of(deq[k].cpu()), bits_of(deq_c[k]))
                    and torch.equal(bits_of(err[k].cpu()),
                                    bits_of(err_c[k]))):
                fail(f"phase 14e compress_grads_with_feedback {k}: the "
                     f"card and the CPU differ")
    log(f"phase 14e int8 compression of {len(grads)} gradients "
        f"({codes} codes) on the card: codes and scales equal the CPU's "
        f"bit for bit, and two steps of error feedback too")
    return {"tensors": len(grads), "codes": codes}


def lm_train_phases(torch, dev) -> dict:
    """Phase 14: the kernels line's record of the wgmma masked matmul on
    the LM training path."""
    import shutil
    import tempfile

    torch.cuda.empty_cache()
    rec = {"name": "masked_matmul_wgmma_forward", "route": "cuda",
           "source": MM_WGMMA_SOURCE,
           "replaces": "src/repro/kernels/masked_matmul.py:23"}
    rec.update(ffn_masked_matmul_phase(torch, dev))
    rec["swiglu_quant"] = ffn_fused_phase(torch, dev)
    tmp = tempfile.mkdtemp(prefix="lm_train_")
    try:
        train_out, cfg, model = lm_train_phase(torch, dev, tmp)
        rec["launches"] = train_out["launches"]
        rec["launches_by_route"] = train_out["launches_by_route"]
        rec["lm_training"] = train_out
        serving = lm_trained_serving_phase(torch, dev, cfg, model)
        rec["launches_decode"] = serving["launches_decode"]
        rec["lm_serving"] = serving
        del model
        torch.cuda.empty_cache()
        rec["checkpoint"], run = lm_checkpoint_phase(torch, dev, tmp)
        rec["compress"] = compress_phase(torch, dev, run)
        del run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


# -- phase 15: the MoE and SSM families at full width ----------------------

FAMILY_ARCHS = ("olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b")
# float32 decode against prefill in an SSM stack: (atol, rtol).  Both
# compute one recurrence in float32, the prefill as the chunked scan's
# products, decode one token at a time.  The dense decoders' 1e-4 / 1e-4
# held over qwen3-1.7b's 28 layers (phase 9b); an SSM stack sums 48-54
# layers' rounding in another order, about twice as many, so twice that
SSM_DECODE_TOL = (2e-4, 2e-4)


def attention_layers(cfg) -> int:
    """Flash launches a prefill makes: one an attention layer (a hybrid's
    shared layer once a site; none in a plain SSM stack)."""
    if not cfg.is_ssm:
        return cfg.n_layers
    return cfg.n_layers // cfg.hybrid_attn_every if cfg.is_hybrid else 0


def no_drop_config(cfg):
    """``cfg`` at MoE capacity E / k, where an expert has a place for
    every token of its group, so no (token, k) pair is dropped."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def drops_per_call(routes, cfg) -> list:
    """(token, k) pairs each recorded router call lost to capacity: the
    call's tokens form groups of ``moe.GROUP_TOKENS`` (decode: the slots)
    at ``cfg``'s capacity."""
    from repro_torch.models import moe
    out = []
    for r in routes:
        topi = r["topi"].reshape(-1, cfg.moe.top_k)
        gs = min(moe.GROUP_TOKENS, topi.shape[0])
        out.append(moe.dropped_pairs(topi.reshape(-1, gs, cfg.moe.top_k),
                                     cfg.moe.n_experts,
                                     moe.capacity(cfg, gs)))
    return out


def decode_logits(torch, dev, cfg, model, tokens, frames=None):
    """``tokens`` (B, S) fed one at a time through ``make_decode_step``
    into a fresh S-slot cache (its KV leaves float32 at float32 compute;
    an encoder-decoder's memory of ``frames`` written by
    ``write_cross_memory`` into its bfloat16 leaves): the (B, S, V)
    logits, float32."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    b, s = tokens.shape
    cache = M.init_cache(cfg, b, s, device=dev)
    if cfg.compute_dtype == "float32":
        cache = {k: v.float() if k in ("k", "v", "shared_k", "shared_v")
                 else v for k, v in cache.items()}
    if frames is not None:
        M.write_cross_memory(model, cache, frames)
    decode = steps.make_decode_step(cfg)
    got = []
    for t in range(s):
        lg, cache = decode(model, cache, tokens[:, t:t + 1],
                           torch.full((b,), t, dtype=torch.int32, device=dev))
        got.append(lg)
    return torch.stack(got, 1).float()


def decode_compare(got, want, held, atol: float, rtol: float) -> dict:
    """Decode's logits (B, S, V) against prefill's: over the ``held``
    positions ((B, S) bool) and over all, and phase 9b's reading of each
    row's last position (logits past the tolerance, top-1 token)."""
    diff = (got - want).abs().cpu().numpy()
    over = diff > atol + rtol * want.abs().cpu().numpy()
    same = (got.argmax(-1) == want.argmax(-1)).cpu().numpy()
    return {"positions_held": int(held.sum()),
            "max_abs": float(diff[held].max()) if held.any() else None,
            "mean_abs": float(diff[held].mean()) if held.any() else None,
            "over": int(over[held].sum()), "logits": int(over[held].size),
            "top1_equal": int(same[held].sum()),
            "max_abs_all_positions": float(diff.max()),
            "over_all_positions": int(over.sum()),
            "last_over": int(over[:, -1].sum()),
            "last_logits": int(over[:, -1].size),
            "last_top1_equal": int(same[:, -1].sum())}


# olmoe-1b-7b's bfloat16 decode against prefill with each router free: the
# positions whose expert sets agree with prefill's in every layer were 36
# and 38 of 128 on an H100 80GB HBM3 at 700 W; a quarter below that
MOE_BF16_MIN_HELD = 27


def family_decode_check(torch, dev, cfg, model, tokens) -> dict:
    """Phase 15, decode against prefill: ``tokens`` (2, 64) fed one at a
    time through ``decode_step`` against one prefill's logits at every
    position, at float32 compute (a float32 KV cache) and the config's
    bfloat16.  A MoE model runs at capacity E / k and must drop nothing.

    * float32: within 1e-4 / 1e-4 (the decoder) or ``SSM_DECODE_TOL`` (an
      SSM stack) at every logit of each position before the first whose
      expert set differs from prefill's in some layer (none so far), at
      least half the positions;
    * bfloat16, a MoE model, its routers free: the 0.05 contract on all
      but 1e-4 of the logits of the positions whose expert sets agree
      with prefill's in every layer (a router near-tie that the two
      summation orders settle apart moves a token past 0.05), at least
      ``MOE_BF16_MIN_HELD`` of them;
    * bfloat16, a MoE model, each decode step's routers pinned to
      prefill's choices (:func:`pin_routing`): the 0.05 contract on all but
      1e-4 of the logits at every position, and phase 9b's rule at each
      row's last position (its logits within 0.05 but for 1e-4 of them,
      the same top-1 token);
    * bfloat16, an SSM stack: reported, not held (the reference's decode
      runs its conv in float32, its prefill in bfloat16).

    Each run is reported over every position too."""
    import dataclasses

    import numpy as np

    from repro_torch.models import model as M
    b, s = tokens.shape
    out = {}
    for name in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=name)
        if c.moe is not None:
            c = no_drop_config(c)
        m = M.LM(c, model.params)
        with record_routing() as pre_routes:
            want = M.forward(m, {"tokens": tokens}).float()
        with record_routing() as dec_routes:
            got = decode_logits(torch, dev, c, m, tokens)
        differ = np.zeros((b, s), bool)
        if c.moe is not None:
            drops = sum(drops_per_call(dec_routes, c))
            if drops:
                fail(f"{cfg.arch_id} {name} decode at capacity E / k "
                     f"dropped {drops} pairs")
            differ = routes_differ(route_sets(pre_routes, (b, s)),
                                   decode_routes(dec_routes, c.n_layers, b,
                                                 s))
        if name == "float32":
            atol, rtol = SSM_DECODE_TOL if c.is_ssm else (1e-4, 1e-4)
            held, least = ~at_or_after(differ), b * s // 2
        else:
            atol = rtol = 0.05
            held, least = ~differ, MOE_BF16_MIN_HELD
        rec = decode_compare(got, want, held, atol, rtol)
        rec["positions_route_differs"] = int(differ.sum())
        gated = not (name == "bfloat16" and c.is_ssm)
        allowed = 0 if name == "float32" else rec["logits"] * 1e-4
        out[name] = rec | {"gated": gated}
        log(f"phase 15 {cfg.arch_id} {name} compute: {b} prompts x {s} "
            f"tokens decoded one at a time against one prefill: "
            f"{rec['positions_held']} of {b * s} positions held (expert set "
            f"differs at {rec['positions_route_differs']}), max |decode - "
            f"prefill| {rec['max_abs']}, mean {rec['mean_abs']}, "
            f"{rec['over']} of {rec['logits']} logits beyond atol {atol} + "
            f"rtol {rtol}; top-1 equal at {rec['top1_equal']} of "
            f"{rec['positions_held']}; over all positions max "
            f"{rec['max_abs_all_positions']}, "
            f"{rec['over_all_positions']} logits beyond"
            + (f"; 0 pairs dropped at capacity {c.moe.capacity_factor}"
               if c.moe else "") + ("" if gated else " (reported)"))
        if gated and (rec["positions_held"] < least
                      or rec["over"] > allowed):
            fail(f"{cfg.arch_id} {name}: decode differs from prefill "
                 f"(at least {least} positions held, {allowed:.0f} logits "
                 f"allowed past the tolerance): {rec}")
        if name == "bfloat16" and c.moe is not None:
            choices = [r["topi"][:, t:t + 1] for t in range(s)
                       for r in pre_routes]
            with pin_routing(choices):
                got = decode_logits(torch, dev, c, m, tokens)
            pin = decode_compare(got, want, np.ones((b, s), bool), atol,
                                 rtol)
            out["bfloat16_pinned"] = pin
            log(f"phase 15 {cfg.arch_id} bfloat16 compute, decode's routers "
                f"pinned to prefill's choices: max |decode - prefill| "
                f"{pin['max_abs']}, mean {pin['mean_abs']}, {pin['over']} of "
                f"{pin['logits']} logits beyond atol {atol} + rtol {rtol}, "
                f"top-1 equal at {pin['top1_equal']} of {b * s}; last "
                f"positions: {pin['last_over']} of {pin['last_logits']} "
                f"logits beyond, top-1 equal in {pin['last_top1_equal']} of "
                f"{b} rows")
            if (pin["over"] > pin["logits"] * 1e-4
                    or pin["last_over"] > pin["last_logits"] * 1e-4
                    or pin["last_top1_equal"] != b):
                fail(f"{cfg.arch_id} bfloat16: decode pinned to prefill's "
                     f"experts differs from prefill: {pin}")
        del m, want, got
    return out


def dispatch_check(torch, dev, cfg, model, tokens) -> dict:
    """Phase 15a, the three MoE dispatches at full width.  Layer by layer
    on one input (the dense prefill's own hidden states), so that every
    dispatch routes the same tokens: ``sorted_local`` against ``dense`` at
    the config's capacity (the same pairs kept, drops included), and at
    capacity E / k ``sorted`` against both, each within the 0.05 contract
    (they differ in bfloat16 summation order: dense sums a token's k
    expert outputs in float32 in one product, the sorted ones add them in
    bfloat16 one at a time).  Then the model's prefill end to end with
    ``sorted_local``, beside dense's: the last positions' logits, reported
    with the router choices that differ between the two (near-ties the two
    orders settle apart move a token's expert set)."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.models import attention as ATT
    from repro_torch.models import moe
    from repro_torch.models.layers import embed_lookup, rms_norm
    from repro_torch.models.model import LM
    w = model.compute_params()
    wide = no_drop_config(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    h = embed_lookup(w["embed"], tokens, cdt)
    b, s = tokens.shape
    pos = torch.arange(s, device=dev).expand(b, s)
    worst = {"sorted_local": 0.0, "sorted_8": 0.0, "sorted_local_8": 0.0}
    drops = []
    for p in w["layers"]:
        h = h + ATT.attn_apply(p["attn"], cfg, rms_norm(h, p["ln1"],
                                                        cfg.norm_eps), pos)
        hn = rms_norm(h, p["ln2"], cfg.norm_eps)
        with record_routing() as routes:
            dense = moe.moe_apply_dense(p["moe"], cfg, hn)[0]
        drops.append(sum(drops_per_call(routes, cfg)))
        pairs = {"sorted_local": (moe.moe_apply_sorted_local(
            p["moe"], cfg, hn)[0], dense)}
        dense8 = moe.moe_apply_dense(p["moe"], wide, hn)[0]
        sorted8 = moe.moe_apply_sorted(p["moe"], wide, hn)[0]
        pairs["sorted_8"] = (sorted8, dense8)
        pairs["sorted_local_8"] = (sorted8, moe.moe_apply_sorted_local(
            p["moe"], wide, hn)[0])
        for key, (x, y) in pairs.items():
            d = (x.float() - y.float()).abs()
            if bool((d > 0.05 + 0.05 * y.float().abs()).any()):
                fail(f"{cfg.arch_id} {key}: a MoE layer's output differs "
                     f"from its yardstick by {float(d.max())}")
            worst[key] = max(worst[key], float(d.max()))
        h = h + dense
        del pairs, dense8, sorted8
    # end to end
    prefill = steps.make_prefill_step(cfg)
    local_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="sorted_local"))
    with record_routing() as dense_routes:
        want = prefill(model, {"tokens": tokens}).float()
    with record_routing() as local_routes:
        got = steps.make_prefill_step(local_cfg)(
            LM(local_cfg, model.params), {"tokens": tokens}).float()
    differ = routes_differ(route_sets(dense_routes, (b, s)),
                           route_sets(local_routes, (b, s)))
    e2e = float((got - want).abs().max())
    over = int(((got - want).abs() > 0.05 + 0.05 * want.abs()).sum())
    rec = {"layer_max_abs": worst, "drops_by_layer": drops,
           "end_to_end_last_max_abs": e2e, "end_to_end_over": over,
           "end_to_end_logits": got.numel(),
           "end_to_end_route_differs": int(differ.sum()),
           "end_to_end_top1_equal": int((got.argmax(-1) == want.argmax(-1))
                                        .sum())}
    log(f"phase 15a {cfg.arch_id} dispatch, layer by layer on the dense "
        f"prefill's hidden states: max |sorted_local - dense| "
        f"{worst['sorted_local']:.4g} at capacity "
        f"{cfg.moe.capacity_factor} ({sum(drops)} pairs dropped over the "
        f"{cfg.n_layers} layers: {drops}); at capacity "
        f"{wide.moe.capacity_factor}: |sorted - dense| "
        f"{worst['sorted_8']:.4g}, |sorted - sorted_local| "
        f"{worst['sorted_local_8']:.4g} (the 0.05 contract); end to end "
        f"the sorted_local prefill's last logits within {e2e:.4g} of "
        f"dense's ({over} of {got.numel()} beyond 0.05 + 0.05 |x|), top-1 "
        f"equal in {rec['end_to_end_top1_equal']} of {b} "
        f"rows; {rec['end_to_end_route_differs']} of {b * s} positions "
        f"route to another expert set in some layer")
    if not bool(torch.isfinite(got).all()):
        fail(f"{cfg.arch_id} sorted_local prefill: logits not finite")
    return rec


def family_phase(torch, dev, arch: str) -> dict:
    """Phase 15 for one architecture at its full published width, the
    port's seeded init, every launch counter at 0 first."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve_lm, steps
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = steps.init_params(cfg, seed=0, device=dev)
    model.compute_params()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.values())
    log(f"phase 15 {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}"
        + (f", {cfg.moe.n_experts} experts top {cfg.moe.top_k}, d_ff "
           f"{cfg.d_ff}" if cfg.moe else "")
        + (f", SSM d_state {cfg.ssm.d_state} head_dim {cfg.ssm.head_dim}"
           if cfg.ssm else "")
        + (f", shared attention every {cfg.hybrid_attn_every} layers "
           f"(Hq {cfg.n_heads}, head_dim {cfg.resolved_head_dim})"
           if cfg.is_hybrid else "")
        + f", vocab {cfg.vocab}: {n_params} parameters drawn and cast in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    reset_all()
    torch.cuda.synchronize()
    rec = {"params": n_params}
    # (a) prefill 4 x 2048 through make_prefill_step
    b, s = PREFILL_SHAPE
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    t0 = time.perf_counter()
    logits = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    n_attn = attention_layers(cfg)
    by_route = dict(flash_attention.launches_by_route)
    if flash_attention.launches != n_attn or by_route["wgmma"] != n_attn:
        fail(f"{arch} prefill launched flash_attention "
             f"{flash_attention.launches} times ({by_route}), not {n_attn} "
             f"on wgmma")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{arch} prefill logits {tuple(logits.shape)} not finite")
    log(f"phase 15 {arch} prefill {b} x {s} tokens: flash_attention "
        f"launched {n_attn} times, all wgmma (head_dim "
        f"{cfg.resolved_head_dim}, Hq {cfg.n_heads} = Hkv "
        f"{cfg.n_kv_heads}), logits finite, first call {first_ms:.1f} ms")
    rec.update({"prefill_launches": n_attn, "prefill_first_ms": first_ms})
    # the server at its defaults: the rest of the main path
    with record_routing() as routes:
        res = serve_lm.serve(cfg, model)
    torch.cuda.synchronize()
    if len(res.done) != 12 or any(len(r["out"]) != 24 for r in res.done):
        fail(f"{arch}: served {len(res.done)} of 12 requests")
    step_ms = res.seconds / res.steps * 1e3
    rec.update({"decode_step_ms": step_ms,
                "decode_tokens_per_s": res.tokens / res.seconds,
                "decode_steps": res.steps})
    msg = ""
    if cfg.moe is not None:
        per_call = drops_per_call(routes, cfg)
        per_step = [sum(per_call[i:i + cfg.n_layers])
                    for i in range(0, len(per_call), cfg.n_layers)]
        pairs = res.slots * cfg.moe.top_k * cfg.n_layers
        rec["serve_drops_per_step"] = {
            "mean": statistics.mean(per_step), "max": max(per_step),
            "steps_without": per_step.count(0), "pairs_per_step": pairs,
            "capacity": moe.capacity(cfg, res.slots)}
        msg = (f"; at capacity {cfg.moe.capacity_factor} each decode step "
               f"dropped {statistics.mean(per_step):.2f} of its {pairs} "
               f"(token, k) pairs on average ({per_step.count(0)} of "
               f"{len(per_step)} steps none, max {max(per_step)})")
    log(f"phase 15 {arch} served {len(res.done)} requests, {res.tokens} "
        f"tokens in {res.steps} decode steps: {step_ms:.3f} ms/step (host "
        f"clock, synchronised every step), "
        f"{res.tokens / res.seconds:.1f} tokens/s{msg}")
    # the main path's launches: the prefill's and the server's (a decode
    # step launches no flash); the checks below count apart
    rec.update({"launches": flash_attention.launches,
                "launches_by_route": dict(flash_attention.launches_by_route)})
    # the checks: the three dispatches, decode against prefill
    reset_all()
    if cfg.moe is not None:
        rec["dispatch"] = dispatch_check(torch, dev, cfg, model, tokens)
    d_tokens = tokens[:DECODE_CHECK_SHAPE[0],
                      :DECODE_CHECK_SHAPE[1]].contiguous()
    rec["decode_vs_prefill"] = family_decode_check(torch, dev, cfg, model,
                                                   d_tokens)
    rec.update({"check_launches": flash_attention.launches,
                "check_launches_by_route": dict(
                    flash_attention.launches_by_route)})
    log(f"phase 15 {arch} flash launches: main path (prefill and serve) "
        f"{rec['launches']} {rec['launches_by_route']}; the checks "
        f"(dispatch, decode against prefill) {rec['check_launches']} "
        f"{rec['check_launches_by_route']}")
    # (d) times: prefill and a decode step profiled, peak memory
    pre = step_profile(torch, lambda: prefill(model, {"tokens": tokens}),
                       iters=3, lead=1)
    cache = M.init_cache(cfg, 4, 128, device=dev)
    tok = tokens[:, :1].contiguous()
    posv = torch.zeros((4,), dtype=torch.int32, device=dev)
    decode = steps.make_decode_step(cfg)
    dec = step_profile(torch, lambda: decode(model, cache, tok, posv)[0]
                       .argmax(-1).cpu(), iters=10, lead=3)
    del cache
    peak = torch.cuda.max_memory_allocated()
    for name, r in (("prefill", pre), ("decode", dec)):
        rec[f"{name}_host_ms"] = r["host_ms"]
        rec[f"{name}_device_ms"] = r["device_ms"]
        rec[f"{name}_idle_share"] = r["idle_share"]
        rec[f"{name}_kernels"] = r["kernels_per_step"]
        rec[f"{name}_device_ms_by_kind"] = r["device_ms_by_kind"]
        rec[f"{name}_top_kernels"] = r["top_kernels"]
        what = "4 x 2048" if name == "prefill" else "4 slots, cache 128"
        log(f"phase 15 {arch} {name} ({what}, profiled): "
            f"{r['host_ms']:.3f} ms host clock, {r['device_ms']:.3f} ms "
            f"device, device idle {r['idle_share'] * 100:.1f} %, "
            f"{r['kernels_per_step']} kernels; by kind "
            f"{r['device_ms_by_kind']}; "
            f"top kernels (ms): {r['top_kernels']}")
    rec["max_memory_allocated"] = peak
    log(f"phase 15 {arch}: max_memory_allocated {peak} B "
        f"({peak / 1e9:.2f} GB)")
    del model, logits
    torch.cuda.empty_cache()
    return rec


def flash_mha_times(torch, dev) -> dict:
    """Phase 15d, flash attention at the new paths' head shapes, bfloat16
    causal MHA: zamba2-2.7b's (4, 32, 2048, 80) and olmoe-1b-7b's
    (4, 16, 2048, 128): event and device time beside
    ``F.scaled_dot_product_attention(enable_gqa=True)`` (``library_ms``),
    the plain version and the bound (q, k, v and out moved once over
    3.35 TB/s against 4 B Hq D flops an unmasked (q, k) pair over
    989 TFLOP/s)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    rec = {}
    b, s = PREFILL_SHAPE
    for h, d in ((32, 80), (16, 128)):
        q, k, v = flash_inputs(torch, dev, b, h, h, s, d, "bfloat16")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 5, 7)
        dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           5, device_bound=True)
        lib = cuda_ms(lambda: sdpa(q, k, v), 5, 7)
        plain = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        1, 3)
        moved = nbytes(q, k, v) + q.numel() * q.element_size()
        ops = 4 * b * h * d * (s * (s + 1) // 2)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S["bfloat16"] * 1e3
        key = f"mha_d{d}"
        rec[key] = {"shape": [b, h, h, s, d], "ms": ms, "device_ms": dev_ms,
                    "library_ms": lib, "plain_ms": plain,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else
                    "operations"}
        log(f"phase 15d flash_attention_forward (B, Hq, Hkv, S, D) ({b}, "
            f"{h}, {h}, {s}, {d}) bfloat16 causal (wgmma): {ms:.4f} ms/call, "
            f"device {dev_ms} ms, SDPA {lib:.4f} ms ({ms / lib:.2f}x), plain "
            f"{plain:.4f} ms, bound {max(bytes_ms, ops_ms):.5f} ms ({moved} "
            f"B, {ops} flop: {ops / ms / 1e9:.1f} TFLOP/s achieved)")
        del q, k, v
        torch.cuda.empty_cache()
    return rec


def lm_family_phases(torch, dev) -> dict:
    """Phase 15: olmoe-1b-7b, mamba2-370m and zamba2-2.7b at full width,
    then flash at their head shapes."""
    out = {arch: family_phase(torch, dev, arch) for arch in FAMILY_ARCHS}
    out["flash"] = flash_mha_times(torch, dev)
    return out


# -- phase 16: the encoder-decoder and M-RoPE families at full width ------

ENCDEC_ARCHS = ("whisper-medium", "qwen2-vl-2b")
WHISPER_TEXT = 448       # whisper's text context (arXiv:2212.04356)
ENCDEC_DECODE_STEPS = 24
ENCDEC_CACHE = 128
# whisper-medium's float32 decode against its float32 prefill, atol at every
# logit of every position: decode reads the memory's K and V from the
# bfloat16 cache (as the reference's does), prefill computes them in
# float32.  The bfloat16 contract's 0.05, stated in PERF.md before the
# first run on the card
ENCDEC_DECODE_ATOL = 0.05
# qwen2-vl-2b's float32 decode against prefill at position 0, where the
# reference's M-RoPE decode and prefill positions agree: (atol, rtol)
VLM_POS0_TOL = (1e-4, 1e-4)


def token_disagreements(mine, want_logits, want_tokens,
                        atol: float = 0.05, rtol: float = 0.05
                        ) -> tuple[int, int]:
    """Greedy tokens ``mine`` (numpy, (B, N)) against the reference's
    ``want_tokens``: ``(how many differ, how many of those take a token
    whose reference logit lies below the reference's top one by more than
    atol + rtol |top|)``.  The second must be 0 wherever logits are held
    to that contract: a token may differ only at a near-tie (the
    reference's bfloat16 logits hold exact ties) that the contract cannot
    order."""
    import numpy as np
    differ = mine != want_tokens
    top = want_logits.max(-1)
    chosen = np.take_along_axis(want_logits, mine[..., None], -1)[..., 0]
    outside = differ & (chosen < top - (atol + rtol * np.abs(top)))
    return int(differ.sum()), int(outside.sum())


def encdec_flash_layers(cfg) -> dict:
    """Flash launches of a prefill by route, at bfloat16 compute: whisper's
    encoder and cross-attention (float32 there, as in the reference: the
    tf32x3 route) and its decoder's self-attention; a decoder's layers."""
    if cfg.enc_dec:
        return {"simt": 0, "wgmma": cfg.n_layers,
                "tf32x3": cfg.n_enc_layers + cfg.n_layers}
    return {"simt": 0, "wgmma": cfg.n_layers, "tf32x3": 0}


def encdec_vlm_smoke_phase(torch, dev) -> dict:
    """Phase 8, the encoder-decoder and VLM families: their smoke configs
    with the reference's params against ``lm_smoke_encdec_vlm.npz``:
    prefill (qwen2-vl with and without ``vision_embeds``), whisper's
    encoder memory (float32 at either compute dtype), and 8 teacher-forced
    decode steps from a cache whose memory ``write_cross_memory`` wrote:
    logits within ``LM_TOL``, greedy tokens by :func:`token_disagreements`
    (equal at float32)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    with np.load(FIXTURE / "lm_smoke_encdec_vlm.npz") as z:
        fx = {k: z[k] for k in z.files}
    out = {}
    for arch in ENCDEC_ARCHS:
        pre = f"{arch}.params."
        arrays = {k[len(pre):]: v for k, v in fx.items()
                  if k.startswith(pre)}
        batch = {"tokens": torch.from_numpy(fx[f"{arch}.tokens"]).to(dev)}
        for key in ("frames", "vision_embeds"):
            if f"{arch}.{key}" in fx:
                batch[key] = torch.from_numpy(fx[f"{arch}.{key}"]).to(
                    dev).bfloat16()
        for cd in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype=cd)
            model = M.from_reference(cfg, arrays, device=dev)
            before = flash_attention.launches
            logits = M.forward(model, batch)
            torch.cuda.synchronize()
            want_n = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers
                                     if cfg.enc_dec else 0)
            if flash_attention.launches - before != want_n:
                fail(f"{arch} {cd} prefill launched flash_attention "
                     f"{flash_attention.launches - before} times, not "
                     f"{want_n}")
            errs = [lm_check(f"{arch} {cd} prefill", logits,
                             fx[f"{arch}.{cd}.prefill"], cd)]
            if cfg.vision_tokens:
                errs.append(lm_check(
                    f"{arch} {cd} prefill without vision_embeds",
                    M.forward(model, {"tokens": batch["tokens"]}),
                    fx[f"{arch}.{cd}.prefill_text"], cd))
            if cfg.enc_dec:
                w = model.compute_params()
                memory = M._forward_encoder(
                    cfg, w, batch["frames"].to(getattr(torch, cd)),
                    M._serve_blocks(cfg)["enc"])
                if memory.dtype != torch.float32:
                    fail(f"{arch} {cd}: the encoder memory is "
                         f"{memory.dtype}, not float32")
                errs.append(lm_check(f"{arch} {cd} encoder memory", memory,
                                     fx[f"{arch}.{cd}.memory"], cd))
            want = fx[f"{arch}.{cd}.decode"]
            b, n = want.shape[:2]
            cache = M.init_cache(cfg, b, n, device=dev)
            cache = {k: v.to(getattr(torch, cd)) if k in ("k", "v") else v
                     for k, v in cache.items()}
            if cfg.enc_dec:
                M.write_cross_memory(model, cache, batch["frames"])
            decode = steps.make_decode_step(cfg)
            got = []
            for t in range(n):
                lg, cache = decode(model, cache, batch["tokens"][:, t:t + 1],
                                   torch.full((b,), t, dtype=torch.int32,
                                              device=dev))
                got.append(lg)
            got = torch.stack(got, 1)
            e_dec = lm_check(f"{arch} {cd} decode", got, want, cd)
            differ, outside = token_disagreements(
                got.float().argmax(-1).cpu().numpy(), want,
                fx[f"{arch}.{cd}.decode_tokens"], *LM_TOL[cd])
            if outside or (cd == "float32" and differ):
                fail(f"{arch} {cd} decode: {differ} greedy tokens differ "
                     f"from the reference's, {outside} outside its "
                     f"near-ties")
            out[f"{arch}.{cd}"] = max(errs + [e_dec])
            log(f"phase 8 {arch} {cd}: prefill max |port - reference| "
                f"{errs[0]:.3g}" + (f", without vision_embeds {errs[1]:.3g}"
                                    if cfg.vision_tokens else "")
                + (f", encoder memory (float32) {errs[1]:.3g}"
                   if cfg.enc_dec else "")
                + f", decode {e_dec:.3g} (atol/rtol {LM_TOL[cd][0]}); "
                f"greedy tokens: {differ} of {b * n} differ (reference "
                f"near-ties)")
    return out


def encdec_decode_check(torch, dev, cfg, model, tokens, frames) -> dict:
    """Phase 16, float32 decode against float32 prefill: ``tokens`` (2,
    64) fed one at a time through ``make_decode_step`` (k and v held in
    float32).  whisper: its memory written by ``write_cross_memory`` into
    the bfloat16 cache, every logit of every position held to
    ``ENCDEC_DECODE_ATOL``.  qwen2-vl (text tokens, no vision_embeds):
    position 0 held to ``VLM_POS0_TOL``; the later positions reported
    (the reference decodes M-RoPE position p at (p, p, p), its prefill
    at p - 256 + 16)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import model as M
    c = dataclasses.replace(cfg, compute_dtype="float32")
    m = M.LM(c, model.params)
    batch = {"tokens": tokens}
    if c.enc_dec:
        batch["frames"] = frames
    want = M.forward(m, batch).float()
    got = decode_logits(torch, dev, c, m, tokens, frames=frames)
    diff = (got - want).abs()
    per_pos = diff.amax(dim=(0, 2)).cpu().numpy()
    same = (got.argmax(-1) == want.argmax(-1)).cpu().numpy()
    rec = {"max_abs": float(diff.max()), "max_abs_by_position":
           [float(x) for x in per_pos], "top1_equal": int(same.sum()),
           "positions": int(same.size)}
    b, s = tokens.shape
    if c.enc_dec:
        rec["atol"] = ENCDEC_DECODE_ATOL
        log(f"phase 16 {cfg.arch_id} float32 compute: {b} prompts x {s} "
            f"tokens decoded one at a time (memory from the bfloat16 cache) "
            f"against one prefill (memory float32): max |decode - "
            f"prefill| {rec['max_abs']:.4g} (gate {ENCDEC_DECODE_ATOL} at "
            f"every logit), worst position {int(np.argmax(per_pos))}, mean "
            f"{float(diff.mean()):.3g}; top-1 equal at "
            f"{rec['top1_equal']} of {b * s} positions")
        if not rec["max_abs"] <= ENCDEC_DECODE_ATOL:
            fail(f"{cfg.arch_id}: float32 decode differs from prefill by "
                 f"{rec['max_abs']} > {ENCDEC_DECODE_ATOL}")
    else:
        atol, rtol = VLM_POS0_TOL
        d0 = diff[:, 0]
        over = int((d0 > atol + rtol * want[:, 0].abs()).sum())
        rec.update({"pos0_max_abs": float(d0.max()), "pos0_over": over,
                    "later_max_abs": float(diff[:, 1:].max()),
                    "later_min_of_max_abs": float(per_pos[1:].min())})
        log(f"phase 16 {cfg.arch_id} float32 compute: {b} text prompts x "
            f"{s} tokens decoded one at a time against one prefill: "
            f"position 0 max |decode - prefill| {rec['pos0_max_abs']:.3g} "
            f"({over} logits beyond atol {atol} + rtol {rtol}); positions "
            f"1-{s - 1} (M-RoPE decode at (p, p, p), prefill at p - 256 + "
            f"16, as in the reference; reported) max "
            f"{rec['later_max_abs']:.4g}, each position at least "
            f"{rec['later_min_of_max_abs']:.4g}; top-1 equal at "
            f"{rec['top1_equal']} of {b * s}")
        if over:
            fail(f"{cfg.arch_id}: float32 decode differs from prefill at "
                 f"position 0: {rec}")
    return rec


def encdec_phase(torch, dev, arch: str) -> dict:
    """Phase 16 for one architecture at its full published width, bfloat16,
    the port's seeded init, every launch counter at 0 first: a prefill of
    4 sequences (whisper: 448 tokens against 1500 seeded frames; qwen2-vl:
    2048 tokens, the first 256 seeded vision embeddings) through
    ``make_prefill_step``, whisper's memory written by
    ``write_cross_memory``, then 24 greedy decode steps over 4 slots and a
    cache of 128; then the checks, counted apart, and the profiles."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = steps.init_params(cfg, seed=0, device=dev)
    model.compute_params()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.values())
    log(f"phase 16 {arch}: {cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_frames} "
           f"frames" if cfg.enc_dec else "")
        + f", d_model {cfg.d_model}, Hq {cfg.n_heads} Hkv {cfg.n_kv_heads} "
        f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
        + (f", M-RoPE, {cfg.vision_tokens} vision tokens" if cfg.mrope
           else "")
        + f", vocab {cfg.vocab}: {n_params} parameters drawn and cast in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    b = PREFILL_SHAPE[0]
    s = WHISPER_TEXT if cfg.enc_dec else PREFILL_SHAPE[1]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": tokens}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((b, cfg.enc_frames, cfg.d_model),
                                      generator=gen, device=dev).bfloat16()
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.randn(
            (b, cfg.vision_tokens, cfg.d_model), generator=gen,
            device=dev).bfloat16()
    reset_all()
    torch.cuda.synchronize()
    rec = {"params": n_params, "prefill_shape": [b, s]}
    # (a) prefill through make_prefill_step
    prefill = steps.make_prefill_step(cfg)
    t0 = time.perf_counter()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    by_route = dict(flash_attention.launches_by_route)
    want = encdec_flash_layers(cfg)
    if by_route != want:
        fail(f"{arch} prefill launched flash_attention {by_route}, not "
             f"{want}")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{arch} prefill logits {tuple(logits.shape)} not finite")
    log(f"phase 16 {arch} prefill {b} x {s} tokens"
        + (f" against {b} x {cfg.enc_frames} frames" if cfg.enc_dec else
           f" ({cfg.vision_tokens} vision embeddings each)")
        + f": flash_attention launched {flash_attention.launches} times "
        f"{by_route}, logits finite, first call {first_ms:.1f} ms")
    rec.update({"prefill_launches": flash_attention.launches,
                "prefill_launches_by_route": by_route,
                "prefill_first_ms": first_ms})
    # (b) 24 greedy decode steps, 4 slots, cache 128
    cache = M.init_cache(cfg, b, ENCDEC_CACHE, device=dev)
    if cfg.enc_dec:
        t0 = time.perf_counter()
        M.write_cross_memory(model, cache, batch["frames"])
        torch.cuda.synchronize()
        rec["write_cross_memory_ms"] = (time.perf_counter() - t0) * 1e3
        rec["write_cross_memory_launches"] = (flash_attention.launches
                                              - rec["prefill_launches"])
    before = dict(flash_attention.launches_by_route)
    decode = steps.make_decode_step(cfg)
    tok = tokens[:, :1].contiguous()
    step_s, finite = [], True
    for t in range(ENCDEC_DECODE_STEPS):
        t0 = time.perf_counter()
        lg, cache = decode(model, cache, tok, torch.full(
            (b,), t, dtype=torch.int32, device=dev))
        tok = lg.argmax(-1, keepdim=True)
        finite &= bool(torch.isfinite(lg).all())
        step_s.append(time.perf_counter() - t0)
    dec_routes = {r: flash_attention.launches_by_route[r] - before[r]
                  for r in before}
    per_step = cfg.n_layers if cfg.enc_dec else 0
    if not finite or dec_routes != {"simt": 0, "tf32x3": 0,
                                    "wgmma": per_step * ENCDEC_DECODE_STEPS}:
        fail(f"{arch} decode: finite {finite}, flash launches {dec_routes} "
             f"(want {per_step} wgmma a step)")
    timed = step_s[2:]
    step_ms = statistics.mean(timed) * 1e3
    rec.update({"decode_steps": ENCDEC_DECODE_STEPS,
                "decode_launches_by_route": dec_routes,
                "decode_step_ms": step_ms,
                "decode_tokens_per_s": b / statistics.mean(timed)})
    log(f"phase 16 {arch}: "
        + (f"write_cross_memory {rec['write_cross_memory_ms']:.1f} ms "
           f"({rec['write_cross_memory_launches']} encoder launches), "
           if cfg.enc_dec else "")
        + f"{ENCDEC_DECODE_STEPS} greedy decode steps over {b} slots, "
        f"cache {ENCDEC_CACHE}: logits finite, flash {dec_routes} "
        f"({per_step} a step), {step_ms:.3f} ms/step after the first two "
        f"(host clock, synchronised by each step's finite check), "
        f"{rec['decode_tokens_per_s']:.1f} tokens/s")
    rec.update({"launches": flash_attention.launches,
                "launches_by_route": dict(flash_attention.launches_by_route)})
    del cache
    # (c) the checks, counted apart
    reset_all()
    d_b, d_s = DECODE_CHECK_SHAPE
    rec["decode_vs_prefill"] = encdec_decode_check(
        torch, dev, cfg, model, tokens[:d_b, :d_s].contiguous(),
        batch["frames"][:d_b] if cfg.enc_dec else None)
    rec.update({"check_launches": flash_attention.launches,
                "check_launches_by_route": dict(
                    flash_attention.launches_by_route)})
    log(f"phase 16 {arch} flash launches: main path (prefill, memory, "
        f"decode) {rec['launches']} {rec['launches_by_route']}; the checks "
        f"{rec['check_launches']} {rec['check_launches_by_route']}")
    # (d) times: prefill and a decode step profiled, peak memory
    pre = step_profile(torch, lambda: prefill(model, batch), iters=3,
                       lead=1)
    cache = M.init_cache(cfg, b, ENCDEC_CACHE, device=dev)
    if cfg.enc_dec:
        M.write_cross_memory(model, cache, batch["frames"])
    tok = tokens[:, :1].contiguous()
    posv = torch.zeros((b,), dtype=torch.int32, device=dev)
    dec = step_profile(torch, lambda: decode(model, cache, tok, posv)[0]
                       .argmax(-1).cpu(), iters=10, lead=3)
    del cache
    peak = torch.cuda.max_memory_allocated()
    for name, r in (("prefill", pre), ("decode", dec)):
        for key in ("host_ms", "device_ms", "idle_share"):
            rec[f"{name}_{key}"] = r[key]
        rec[f"{name}_kernels"] = r["kernels_per_step"]
        rec[f"{name}_device_ms_by_kind"] = r["device_ms_by_kind"]
        rec[f"{name}_top_kernels"] = r["top_kernels"]
        what = (f"{b} x {s}" if name == "prefill"
                else f"{b} slots, cache {ENCDEC_CACHE}")
        log(f"phase 16 {arch} {name} ({what}, profiled): "
            f"{r['host_ms']:.3f} ms host clock, {r['device_ms']:.3f} ms "
            f"device, device idle {r['idle_share'] * 100:.1f} %, "
            f"{r['kernels_per_step']} kernels; by kind "
            f"{r['device_ms_by_kind']}; top kernels (ms): "
            f"{r['top_kernels']}")
    rec["max_memory_allocated"] = peak
    log(f"phase 16 {arch}: max_memory_allocated {peak} B "
        f"({peak / 1e9:.2f} GB)")
    del model, logits, batch
    torch.cuda.empty_cache()
    return rec


# phase 16c's shapes: (name, (B, Hq, Hkv, (Sq, Skv), D), dtype, causal)
ENCDEC_FLASH_SHAPES = (
    ("whisper_encoder", (4, 16, 16, (1500, 1500), 64), "float32", False),
    ("whisper_cross_prefill", (4, 16, 16, (WHISPER_TEXT, 1500), 64),
     "float32", False),
    ("whisper_cross_decode", (4, 16, 16, (1, 1500), 64), "bfloat16", False),
    ("qwen2_vl_prefill", (4, 12, 2, (2048, 2048), 128), "bfloat16", True))


def flash_cross_times(torch, dev) -> dict:
    """Phase 16c, flash attention at the new paths' shapes: event and
    device time beside ``F.scaled_dot_product_attention`` (``library_ms``;
    float32 on its memory-efficient backend with K and V expanded to Hq
    heads outside the timed call), the plain version and the bound (q, k,
    v and out moved once over 3.35 TB/s against 4 B Hq D flops an unmasked
    (q, k) pair: bfloat16 at 989 TFLOP/s, float32 three TF32 products a
    product at 495 TFLOP/s, as phase 10 bounds the tf32x3 route)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    rec = {}
    for name, (b, hq, hkv, (sq, skv), d), dtype, causal in \
            ENCDEC_FLASH_SHAPES:
        lens = sq if sq == skv else (sq, skv)
        q, k, v = flash_inputs(torch, dev, b, hq, hkv, lens, d, dtype)
        route = flash_attention_route(q.dtype, d)
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

        def kernel():
            return flash_attention(q, k, v, causal=causal)

        def library():
            if dtype == "float32":
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return F.scaled_dot_product_attention(
                        q, ke, ve, is_causal=causal)
            return sdpa(q, k, v, causal=causal)

        ms = cuda_ms(kernel, 5, 7)
        # one query row against 1500 keys is a few microseconds: launch
        # bound, so its trace is not held to the event time
        dev_ms = device_ms(kernel, 5, device_bound=sq > 1)
        lib = cuda_ms(library, 5, 7)
        plain = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                      causal=causal), 1, 3)
        err = float((kernel().float() - flash_attention_plain(
            q, k, v, causal=causal).float()).abs().max())
        moved = nbytes(q, k, v) + q.numel() * q.element_size()
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        ops = 4 * b * hq * d * pairs
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = (TF32_PRODUCTS * ops / TF32_FLOPS_PER_S if route == "tf32x3"
                  else ops / FLOPS_PER_S[dtype]) * 1e3
        rec[name] = {"shape": [b, hq, hkv, sq, skv, d], "dtype": dtype,
                     "causal": causal, "route": route, "ms": ms,
                     "device_ms": dev_ms, "library_ms": lib,
                     "plain_ms": plain, "max_abs_err": err,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else
                     "operations"}
        log(f"phase 16c flash_attention (B, Hq, Hkv, Sq, Skv, D) ({b}, "
            f"{hq}, {hkv}, {sq}, {skv}, {d}) {dtype} "
            f"{'causal' if causal else 'non-causal'} ({route}): {ms:.4f} "
            f"ms/call, device {dev_ms} ms, SDPA {lib:.4f} ms "
            f"({ms / lib:.2f}x), plain {plain:.4f} ms, max |kernel - plain| "
            f"{err:.3g}, bound {max(bytes_ms, ops_ms):.5f} ms ({moved} B, "
            f"{ops} flop: {ops / ms / 1e9:.1f} TFLOP/s achieved)")
        del q, k, v, ke, ve
        torch.cuda.empty_cache()
    return rec


def lm_encdec_phases(torch, dev) -> dict:
    """Phase 16: whisper-medium and qwen2-vl-2b at full width, then flash
    at their shapes."""
    out = {arch: encdec_phase(torch, dev, arch) for arch in ENCDEC_ARCHS}
    out["flash"] = flash_cross_times(torch, dev)
    return out


# -- phase 17: the families trained: every zoo arch at smoke size against
# the reference's training record, the five families at full width --------

TRAIN_RECORD = "lm_smoke_train.npz"
# the fixtures that hold each arch's smoke init (the training record holds
# phi3-mini-3.8b's and starcoder2-15b's itself, and its LogicNet runs'
# masks: their other leaves are the arch's)
INIT_FIXTURES = {"lm_smoke.npz": ("qwen3-1.7b", "gemma3-27b"),
                 "lm_smoke_moe_ssm.npz": ("olmoe-1b-7b",
                                          "qwen3-moe-235b-a22b",
                                          "mamba2-370m", "zamba2-2.7b"),
                 "lm_smoke_encdec_vlm.npz": ("whisper-medium",
                                             "qwen2-vl-2b")}
FT_ARCHS = ("qwen3-1.7b", "gemma3-27b", "phi3-mini-3.8b", "starcoder2-15b",
            "olmoe-1b-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
            "zamba2-2.7b", "whisper-medium", "qwen2-vl-2b")
FT_LOGICNET = ("qwen3-1.7b", "zamba2-2.7b", "qwen2-vl-2b")
LOGICNET_SUFFIX = "+logicnet"
# the record's runs: 5 steps of AdamW (lr 3e-4, weight decay 0.01,
# cosine_schedule(1, 5)) on TokenStream(seed=0) batches of 4 x 64
FT_STEPS, FT_BATCH, FT_SEQ = 5, 4, 64
FT_LR, FT_DECAY = 3e-4, 0.01
# 17a's gates (the CPU tests hold the port to the same): losses, the
# step-0 global gradient norm, the final float32 parameters
FT_LOSS_RTOL = 1e-3
FT_NORM_RTOL = {"float32": 1e-5, "bfloat16": 0.05}
FT_PARAM_ATOL = 1e-5
# AdamW's first step moves an element by lr * g / (|g| + eps), eps 1e-8,
# g its clipped gradient.  Where g is not 0 but |g| is below
# FT_EPS_CONDITIONED (10 eps) that move follows g's own float32 rounding:
# a gradient of 2e-8 that another summation order reads as 5e-9 moves the
# element by 0.25 lr more (7.5e-5; on the CPU qwen3-1.7b misses 1e-5 by
# this at 1 of 90 496 elements, zamba2-2.7b at 1 of 170 144; 17-817
# elements a run are so conditioned).  Such elements are held to two
# first-step moves (the move's sign may flip with g's); every other
# element, a zero gradient's included, to FT_PARAM_ATOL
FT_EPS_CONDITIONED = 1e-7
FT_CONDITIONED_ATOL = 2 * FT_LR
# 17b: the five families at full width through train.build + loop.run,
# the launcher's defaults (lr 3e-4, remat "full", bfloat16 compute) but
# for these: (arch, --logicnet-ffn, batch, seq, the config's cut)
FT_FULL = (("olmoe-1b-7b", False, 8, 256, {"n_layers": 8}),
           ("mamba2-370m", False, 8, 256, {}),
           ("zamba2-2.7b", True, 8, 256, {}),
           ("whisper-medium", False, 8, 448, {}),
           ("qwen2-vl-2b", True, 8, 1024, {}))
# 17b feeds qwen2-vl-2b seeded standard-normal bfloat16 vision embeddings
# (seed VISION_SEED + step) in place of the launcher's zeros: at 28
# layers a zero row's rms_norm Jacobian, (1 + scale) / sqrt(eps) = 1000,
# grows the gradient at the 256 vision positions about 10^3-fold a layer
# back, and it overflows by layer 14 in the reference as in the port
# (ROADMAP §3), so the first AdamW step writes NaN into every parameter
VISION_SEED = 1000
# steps 1-3 checked (parity, masks, launches; they also warm the caching
# allocator), 4-6 timed on the host clock, 7-10 traced (1 lead, 2
# measured, 1 after): 14b's 16 steps would take the script past 1.5x its
# earlier wall time (whisper's steps take 2.7 s)
FT_HOST_STEPS = (3, 6)
FT_PROFILE_LEAD = 1
FT_PROFILE_ITERS = 2
FT_FULL_STEPS = FT_HOST_STEPS[1] + FT_PROFILE_LEAD + FT_PROFILE_ITERS + 1
# 17c: the masked matmul at the two new FFN shapes, (name, M, mask) as
# 14a's FFN_CASES at each model's M (batch x seq tokens)
FT_FFN_SHAPES = {"zamba2-2.7b": (2560, 10240, 8 * 256),
                 "qwen2-vl-2b": (1536, 8960, 8 * 1024)}
FT_FFN_CASES = ("wi", "wo", "dx_wi", "dx_wo")


def train_runs() -> list:
    """``(run, arch, logicnet)`` of every run of the training record."""
    return ([(a, a, False) for a in FT_ARCHS]
            + [(a + LOGICNET_SUFFIX, a, True) for a in FT_LOGICNET])


def train_record() -> dict:
    """``lm_smoke_train.npz`` as a dict, each run's initial parameters
    under ``<run>.params.`` taken from the fixture that holds its arch's
    (a LogicNet run's masks from the record itself)."""
    import numpy as np
    with np.load(FIXTURE / TRAIN_RECORD) as z:
        fx = {k: z[k] for k in z.files}
    for name, archs in INIT_FIXTURES.items():
        with np.load(FIXTURE / name) as z:
            for k in z.files:
                if k.split(".params.")[0] in archs and ".params." in k:
                    fx[k] = z[k]
    for run, arch, logicnet in train_runs():
        if logicnet:
            pre = f"{arch}.params."
            for k in [k for k in fx if k.startswith(pre)]:
                fx[f"{run}.params.{k[len(pre):]}"] = fx[k]
    return fx


def train_arrays(fx: dict, run: str) -> dict:
    """A run's initial parameters, as ``from_reference`` takes them."""
    pre = f"{run}.params."
    return {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}


def train_config(arch: str, logicnet: bool, dtype: str, capacity=None):
    """The port's smoke config of a run at ``dtype`` compute (and, for a
    MoE, the record's ``capacity`` factor)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import LogicNetFFNCfg
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    if logicnet:
        cfg = dataclasses.replace(cfg, logicnet_ffn=LogicNetFFNCfg())
    if cfg.moe is not None and capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(capacity)))
    return cfg


def train_batch(torch, cfg, step: int, dev) -> dict:
    """Step ``step``'s batch of the record's runs on ``dev``: the
    launcher's (``TokenStream(seed=0)`` at 4 x 64, zero bfloat16
    ``frames`` / ``vision_embeds`` where the model reads them)."""
    from repro_torch.launch import train
    return train.token_batches(cfg, FT_SEQ, FT_BATCH, dev)(step)


def train_five_steps(torch, cfg, arrays: dict, dev) -> dict:
    """The port's side of a run: the reference's init carried in
    (``from_reference``), the step-0 global gradient norm (masks'
    gradients included) and the elements whose clipped step-0 gradient
    lies below ``FT_EPS_CONDITIONED``, then ``FT_STEPS`` steps of
    ``launch.steps.make_train_step`` with the record's AdamW, a MoE's
    router choices recorded step by step."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import (AdamWCfg, cosine_schedule, global_norm,
                                   init_opt_state)
    model = M.from_reference(cfg, arrays, device=dev)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.params.items()}
    del model
    loss = M.loss_fn(params, cfg, train_batch(torch, cfg, 0, dev))
    grads = torch.autograd.grad(loss, list(params.values()))
    norm = float(global_norm(grads))
    scale = min(1.0, 1.0 / max(norm, 1e-12))
    conditioned = {n: (g != 0) & (g.abs() * scale < FT_EPS_CONDITIONED)
                   for n, g in zip(params, grads)}
    del loss, grads
    state = {"params": params, "opt": init_opt_state(params)}
    step = steps.make_train_step(cfg, AdamWCfg(
        lr=FT_LR, weight_decay=FT_DECAY,
        schedule=cosine_schedule(1, FT_STEPS)))
    losses, routes = [], []
    for i in range(FT_STEPS):
        with record_routing() as rec:
            state, loss = step(state, train_batch(torch, cfg, i, dev))
        losses.append(float(loss))
        if cfg.moe is not None:
            routes.append(route_sets(rec, (FT_BATCH, FT_SEQ)))
    return {"losses": losses, "grad_norm0": norm,
            "conditioned": conditioned, "params": state["params"],
            "routes": routes if cfg.moe is not None else None}


def stacked_port(cfg, params: dict, name: str):
    """The port's parameters under the reference's name ``name`` as one
    numpy array, a stacked list's layers stacked again."""
    import numpy as np

    from repro_torch.models import model as M
    stack, _, rest = name.partition(".")
    if stack not in M._STACKED:
        return params[name].detach().float().cpu().numpy()
    return np.stack([params[f"{stack}.{i}.{rest}"].detach().float().cpu()
                     .numpy() for i in range(M.stacked_layers(cfg, stack))])


def masked_init(arrays: dict) -> dict:
    """The reference's initial arrays with each LogicNet weight times its
    sibling mask (``logicnet_mask_fn``): the base of the record's
    ``delta`` (AdamW zeroes a pruned weight in its first step)."""
    from repro_torch.optim.adamw import logicnet_mask_fn
    out = dict(arrays)
    for name, a in arrays.items():
        mask = logicnet_mask_fn(name, arrays)
        if mask is not None:
            out[name] = a * mask
    return out


def first_differing_step(got_routes, topi):
    """The first step whose expert sets differ from the record's (its
    ``topi``, (steps, layers, B, S, K)) at some position in some layer,
    else None."""
    for i, sets in enumerate(got_routes):
        if routes_differ(sets, fixture_route_sets(topi[i])).any():
            return i
    return None


def unexplained_steps(rtol, limit: float, first) -> list:
    """Steps (0-based) whose reading ``rtol`` passes ``limit`` with no
    differing expert set at or before them (``first``: the first step with
    one, or None), as :func:`lm_check_routes` takes positions."""
    return [i for i, r in enumerate(rtol)
            if r > limit and (first is None or i < first)]


def pruned_and_fan_in(params: dict, fan_in: int) -> list:
    """The LogicNet weights (by name) with a pruned weight not 0 or a mask
    column not summing to ``fan_in``."""
    from repro_torch.optim.adamw import logicnet_mask_fn
    bad = []
    for name, w in params.items():
        m = logicnet_mask_fn(name, params)
        if m is None:
            continue
        if bool((w[m == 0] != 0).any()) or bool((m.sum(0) != min(
                fan_in, m.shape[0])).any()):
            bad.append(name)
    return bad


def train_check(run: str, dtype: str, cfg, got: dict, fx: dict) -> dict:
    """17a's gates for one run (the CPU tests apply the same): losses
    within ``FT_LOSS_RTOL``, the step-0 gradient norm within
    ``FT_NORM_RTOL``, at float32 every final parameter within
    ``FT_PARAM_ATOL`` of the record's (``FT_CONDITIONED_ATOL`` where the
    step-0 gradient is eps-conditioned), a LogicNet run's pruned weights 0
    and mask columns at their fan-in.  A MoE run at bfloat16, where one
    bfloat16 step of noise can settle a near-tie of two router logits the
    other way, sets aside the steps from the first whose expert sets
    differ from the record's (reported): a reading past its gate there is
    not a failure, and the readings returned are over the other steps.
    float32 holds every step.  Returns the readings; fails on a miss."""
    import numpy as np
    name = f"{run} {dtype}"
    first = None
    if got["routes"] is not None:
        first = first_differing_step(got["routes"], fx[f"{run}.{dtype}.topi"])
    aside = first if dtype == "bfloat16" else None
    want = fx[f"{run}.{dtype}.losses"]
    losses = np.asarray(got["losses"])
    if losses.shape != want.shape or not np.isfinite(losses).all():
        fail(f"phase 17a {name}: losses {got['losses']}")
    rtol = np.abs(losses - want) / np.abs(want)
    held = FT_STEPS if aside is None else aside
    out = {"losses": got["losses"], "routes_differ_from_step": first,
           "steps_held": held, "loss_rtol": float(rtol[:held].max(
               initial=0.0)), "loss_rtol_all": float(rtol.max())}
    missed = unexplained_steps(rtol, FT_LOSS_RTOL, aside)
    if missed:
        fail(f"phase 17a {name}: losses {got['losses']} against the "
             f"reference's {want.tolist()}: rtol {rtol.tolist()} beyond "
             f"{FT_LOSS_RTOL} at steps {[i + 1 for i in missed]}")
    w = float(fx[f"{run}.{dtype}.grad_norm0"])
    out["norm_rtol"] = abs(got["grad_norm0"] - w) / w
    if unexplained_steps([out["norm_rtol"]], FT_NORM_RTOL[dtype], aside):
        fail(f"phase 17a {name}: step-0 gradient norm "
             f"{got['grad_norm0']} against the reference's {w}: rtol "
             f"{out['norm_rtol']} beyond {FT_NORM_RTOL[dtype]}")
    if cfg.logicnet_ffn is not None:
        bad = pruned_and_fan_in(got["params"], cfg.logicnet_ffn.fan_in)
        if bad:
            fail(f"phase 17a {name}: pruned weights not 0 or mask columns "
                 f"off their fan-in in {bad}")
    if dtype != "float32":
        return out
    base = masked_init(train_arrays(fx, run))
    pre = f"{run}.float32.delta."
    err = cond_err = 0.0
    n_cond = n_elems = 0
    for key in (k for k in fx if k.startswith(pre)):
        ref_name = key[len(pre):]
        want_p = base[ref_name] + fx[key].astype(np.float32)
        got_p = stacked_port(cfg, got["params"], ref_name)
        cond = stacked_port(cfg, {n: c.float() for n, c in
                                  got["conditioned"].items()},
                            ref_name).astype(bool)
        if got_p.shape != want_p.shape:
            fail(f"phase 17a {name}: {ref_name} {got_p.shape} against "
                 f"{want_p.shape}")
        diff = np.abs(got_p - want_p)
        err = max(err, float(diff[~cond].max(initial=0.0)))
        cond_err = max(cond_err, float(diff[cond].max(initial=0.0)))
        n_cond += int(cond.sum())
        n_elems += diff.size
    out.update({"param_err": err, "conditioned": n_cond,
                "conditioned_err": cond_err, "elements": n_elems})
    if err > FT_PARAM_ATOL or cond_err > FT_CONDITIONED_ATOL:
        fail(f"phase 17a {name}: final parameters {err} from the "
             f"reference's (limit {FT_PARAM_ATOL}), the {n_cond} "
             f"eps-conditioned elements {cond_err} (limit "
             f"{FT_CONDITIONED_ATOL})")
    return out


def train_smoke_phase(torch, dev) -> dict:
    """Phase 17a: every run of the training record on the card."""
    from repro_torch.kernels.masked_matmul import masked_matmul
    fx = train_record()
    out = {}
    for run, arch, logicnet in train_runs():
        for dtype in ("float32", "bfloat16"):
            cfg = train_config(arch, logicnet, dtype,
                               fx.get(f"{run}.{dtype}.capacity_factor"))
            before = dict(masked_matmul.launches_by_route)
            got = train_five_steps(torch, cfg, train_arrays(fx, run), dev)
            launched = {k: v - before.get(k, 0) for k, v in
                        masked_matmul.launches_by_route.items()
                        if v != before.get(k, 0)}
            # the LogicNet products: 3 a layer forward and 3 input
            # gradients, in the step-0 gradient and each step (smoke
            # configs do not remat), every one on wgmma at bfloat16
            want = (0 if not logicnet else
                    6 * attention_layers(cfg) * (FT_STEPS + 1))
            route = "wgmma" if dtype == "bfloat16" else "ffma"
            if sum(launched.values()) != want or (
                    want and launched.get(route) != want):
                fail(f"phase 17a {run} {dtype}: masked_matmul launched "
                     f"{launched}, not {want} on {route}")
            rec = train_check(run, dtype, cfg, got, fx)
            rec["masked_matmul_launches"] = launched
            out[f"{run}.{dtype}"] = rec
            held = (f"max rtol {rec['loss_rtol']:.3g} over steps 1-"
                    f"{rec['steps_held']}" if rec["steps_held"] else
                    "no step held")
            log(f"phase 17a {run} {dtype}: losses {rec['losses']} ({held}"
                + (f"; expert sets differ from the reference's from step "
                   f"{rec['routes_differ_from_step'] + 1}, all steps' max "
                   f"rtol {rec['loss_rtol_all']:.3g}"
                   if rec["routes_differ_from_step"] is not None else "")
                + f"), step-0 gradient norm rtol {rec['norm_rtol']:.3g}"
                + (f", final parameters within {rec['param_err']:.3g} "
                   f"({rec['conditioned']} of {rec['elements']} "
                   f"eps-conditioned, within {rec['conditioned_err']:.3g})"
                   if "param_err" in rec else "")
                + (f"; masked_matmul {launched}" if launched else ""))
    return out


def full_train_args(tmp: str, arch: str, logicnet: bool, batch: int,
                    seq: int):
    """``launch.train``'s flags for a 17b run (no checkpoint is written:
    ``--ckpt-every`` lies past the last step)."""
    from repro_torch.launch import train
    return train.parse_args(
        ["--full", "--arch", arch, "--steps", str(FT_FULL_STEPS),
         "--global-batch", str(batch), "--seq", str(seq), "--ckpt-dir",
         tmp, "--ckpt-every", str(10 * FT_FULL_STEPS)]
        + ["--logicnet-ffn"] * logicnet)


def seeded_vision(torch, batches, dev):
    """``batches`` (a run's ``batches(step)``) with seeded standard-normal
    bfloat16 ``vision_embeds`` (``VISION_SEED + step``) in place of the
    launcher's zeros; other batches as they are."""
    def get(step: int) -> dict:
        out = batches(step)
        if "vision_embeds" in out:
            g = torch.Generator(device=dev).manual_seed(VISION_SEED + step)
            out["vision_embeds"] = torch.randn(
                out["vision_embeds"].shape, generator=g,
                device=dev).bfloat16()
        return out
    return get


def full_train_config(args, cut: dict):
    """A 17b run's config: the flags', with its cut (olmoe's depth)."""
    import dataclasses

    from repro_torch.launch import train
    return dataclasses.replace(train.config(args), **cut)


def masked_matmul_per_step(cfg) -> int:
    """Masked-matmul launches a training step at remat "full": 3 forward,
    3 recomputed, 3 input gradients at each LogicNet-FFN (each layer of a
    decoder, each site of a hybrid's shared layer); 0 without one."""
    if cfg.logicnet_ffn is None or cfg.moe is not None or cfg.enc_dec:
        return 0
    return LM_MM_PER_LAYER_STEP * attention_layers(cfg)


def full_train_phase(torch, dev, tmp: str, arch: str, logicnet: bool,
                     batch: int, seq: int, cut: dict) -> dict:
    """Phase 17b for one family at full width."""
    import gc

    from repro_torch.kernels.masked_matmul import masked_matmul
    from repro_torch.launch import train
    from repro_torch.models import layers as model_layers
    from repro_torch.models import moe

    args = full_train_args(tmp, arch, logicnet, batch, seq)
    cfg = full_train_config(args, cut)
    per_step = masked_matmul_per_step(cfg)
    plain_losses = None
    if per_step:
        # the parity run: every FFN product on the plain version
        model_layers.MaskedMatmulFn = PlainMaskedMatmul
        try:
            reset_all()
            plain = train.build(args, cfg)
            plain.loop.run(seeded_vision(torch, plain.batches, dev),
                           LM_PARITY_STEPS)
            plain_losses = [l for _, l in plain.loop.metrics]
            if masked_matmul.launches:
                fail(f"phase 17b {arch} parity run launched masked_matmul "
                     f"{masked_matmul.launches} times")
        finally:
            from repro_torch.kernels.masked_matmul import MaskedMatmulFn
            model_layers.MaskedMatmulFn = MaskedMatmulFn
        del plain
        gc.collect()
        torch.cuda.empty_cache()
    # the main path: every launch counter at 0
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.build(args, cfg)
    run.batches = seeded_vision(torch, run.batches, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    loop = run.loop
    n_params = sum(p.numel() for p in loop.state["params"].values())
    n_masks = sum(p.numel() for n, p in loop.state["params"].items()
                  if "mask" in n)
    rec = {"arch": arch, "logicnet_ffn": logicnet, "batch": batch,
           "seq": seq, "cut": cut, "layers": cfg.n_layers,
           "n_params": n_params, "n_mask_params": n_masks,
           "build_s": build_s, "masked_matmul_per_step": per_step}
    with record_routing() as routes:
        loop.run(run.batches, 1)
        if len(loop.metrics) != 1:
            fail(f"phase 17b {arch}: step 1's loss was not finite")
        if masked_matmul.launches != per_step or (
                per_step and masked_matmul.launches_by_route["wgmma"]
                != per_step):
            fail(f"phase 17b {arch} step 1 launched masked_matmul "
                 f"{masked_matmul.launches_by_route}, not {per_step} on "
                 f"wgmma")
        if per_step:
            bad = pruned_and_fan_in(loop.state["params"],
                                    cfg.logicnet_ffn.fan_in)
            if bad:
                fail(f"phase 17b {arch}: after step 1 a pruned weight is "
                     f"not 0 or a mask column is off its fan-in in {bad}")
        loop.run(run.batches, FT_HOST_STEPS[1])
    losses = [l for _, l in loop.metrics]
    if plain_losses is not None:
        if len(plain_losses) != LM_PARITY_STEPS:
            fail(f"phase 17b {arch}: the parity run's losses "
                 f"{plain_losses}: a step was not finite")
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(losses[:LM_PARITY_STEPS], plain_losses))
        if not rel <= LM_PARITY_RTOL:
            fail(f"phase 17b {arch} losses {losses[:LM_PARITY_STEPS]} "
                 f"against the plain version's {plain_losses}: rtol {rel} "
                 f"beyond {LM_PARITY_RTOL}")
        rec.update({"plain_losses": plain_losses, "parity_rtol": rel})
    if cfg.moe is not None:
        # each step's forward calls (remat records its recomputation too)
        calls = 2 if cfg.remat != "none" else 1
        per_call = drops_per_call(routes, cfg)
        span = calls * cfg.n_layers
        per_step_drops = [sum(per_call[i:i + cfg.n_layers])
                          for i in range(0, len(per_call), span)]
        rec["drops_per_step"] = per_step_drops
        rec["pairs_per_step"] = batch * seq * cfg.moe.top_k * cfg.n_layers
    del routes
    host_ms = 1e3 * statistics.mean(run.step_s[FT_HOST_STEPS[0]:
                                                FT_HOST_STEPS[1]])
    prof = step_profile(torch, lambda: loop.run(run.batches, loop.step + 1),
                        iters=FT_PROFILE_ITERS, lead=FT_PROFILE_LEAD)
    loop.run(run.batches, FT_FULL_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in loop.metrics]
    launches = masked_matmul.launches
    if launches != per_step * loop.step or (
            per_step and masked_matmul.launches_by_route["wgmma"]
            != launches):
        fail(f"phase 17b {arch}: {launches} masked_matmul launches in "
             f"{loop.step} steps ({masked_matmul.launches_by_route}); "
             f"expected {per_step} a step, all wgmma")
    if len(losses) != FT_FULL_STEPS or not all(
            l == l and abs(l) < float("inf") for l in losses):
        fail(f"phase 17b {arch}: losses {losses}")
    line = train.summary(run)
    print(line, flush=True)
    rec.update({"losses": losses, "launches": launches,
                "launches_by_route": dict(masked_matmul.launches_by_route),
                "step_ms": host_ms, "profile": prof, "peak_bytes": peak,
                "train_line": line, "steps": loop.step})
    cut_note = f", cut by {cut}" if cut else ""
    log(f"phase 17b {arch}{' --logicnet-ffn' if logicnet else ''} at full "
        f"width ({cfg.n_layers} layers{cut_note}, batch {batch} x seq "
        f"{seq}): {n_params} float32 parameters "
        f"({n_masks} of them masks), state built in {build_s:.2f} s; "
        f"masked_matmul {launches} launches in {loop.step} steps "
        f"({per_step} a step)"
        + (f"; losses {losses[:LM_PARITY_STEPS]} against {plain_losses} "
           f"with every FFN product on the plain version (max rtol "
           f"{rec['parity_rtol']:.3g}, limit {LM_PARITY_RTOL}); pruned "
           f"weights 0 and mask columns at fan-in after step 1"
           if plain_losses is not None else "")
        + (f"; (token, k) pairs dropped a step {rec['drops_per_step']} of "
           f"{rec['pairs_per_step']} (capacity "
           f"{cfg.moe.capacity_factor}, group {moe.GROUP_TOKENS})"
           if cfg.moe is not None else "")
        + f"; {host_ms:.3f} ms a step on the host clock (synchronised, "
        f"steps {FT_HOST_STEPS[0] + 1}-{FT_HOST_STEPS[1]}); profiled "
        f"steps: {prof['host_ms']:.3f} ms host, {prof['device_ms']:.3f} "
        f"ms device, idle {prof['idle_share'] * 100:.1f} %, "
        f"{prof['kernels_per_step']} kernels a step, device ms by kind "
        f"{prof['device_ms_by_kind']}; top kernels (ms): "
        f"{prof['top_kernels']}; peak {peak / 1e9:.3f} GB allocated "
        f"({torch.cuda.get_device_name(0)})")
    del run, loop
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_families_phase(torch, dev) -> dict:
    """Phase 17: (a) the training record's runs, (b) the five families
    at full width, (c) the masked matmul at their FFN shapes."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out = {"smoke": train_smoke_phase(torch, dev), "full": {}, "seconds": {}}
    out["seconds"]["17a"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="lm_train_families_")
    try:
        for arch, logicnet, batch, seq, cut in FT_FULL:
            t0 = time.perf_counter()
            out["full"][arch] = full_train_phase(torch, dev, tmp, arch,
                                                 logicnet, batch, seq, cut)
            out["seconds"][arch] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    out["ffn_times"] = {
        arch: ffn_masked_matmul_phase(
            torch, dev, d_model, d_ff,
            tuple((name, m, which) for name, _, which in FFN_CASES
                  if name in FT_FFN_CASES), tag="17c")
        for arch, (d_model, d_ff, m) in FT_FFN_SHAPES.items()}
    out["seconds"]["17c"] = time.perf_counter() - t0
    log(f"phase 17 wall seconds: {out['seconds']}")
    return out


# -- phase 18: the mesh path (torch.distributed, DTensor) on one card ------
# 18a: launch.train --full --logicnet-ffn --model-parallel 1 --grad-rs
# (8 x 256, the launcher's defaults) against the same steps unsharded
MESH_STEPS = 3
# 18d: the dry-run's cells traced on both production meshes
MESH_DRYRUN = (("qwen3-1.7b", "train_4k", False),
               ("qwen3-1.7b", "train_4k", True))
MESH_DRYRUN_TIMEOUT_S = 300
MESH_SERVE_TIMEOUT_S = 300


def mesh_train_args(tmp: str, steps: int, mesh: bool):
    """18a's flags: phase 14's, and on the mesh ``--model-parallel 1
    --grad-rs``."""
    from repro_torch.launch import train
    extra = ["--model-parallel", "1", "--grad-rs"] if mesh else []
    return train.parse_args(["--full", "--logicnet-ffn", "--steps",
                             str(steps), "--ckpt-dir", tmp,
                             "--ckpt-every", "1000"] + extra)


def mesh_param(p):
    """A parameter of a (1, 1) mesh's state as a plain tensor (its one
    shard is the whole)."""
    return p.to_local() if hasattr(p, "to_local") else p


def mesh_dryrun_check(rec: dict) -> list:
    """What a production-mesh dry-run record of phase 18d lacks: ``ok``,
    FLOPs and collectives above 0, the mesh's ranks, and on the multi-pod
    mesh the ``pod`` axis on weights."""
    bad = []
    if rec.get("status") != "ok":
        bad.append(f"status {rec.get('status')}: {rec.get('error')}")
        return bad
    if not rec.get("cost", {}).get("flops", 0) > 0:
        bad.append("no FLOPs")
    if not rec.get("collectives", {}).get("total", 0) > 0:
        bad.append("no collectives")
    want = 512 if rec.get("mesh") == "2x16x16" else 256
    if rec.get("chips") != want:
        bad.append(f"{rec.get('chips')} ranks, not {want}")
    if rec.get("mesh") == "2x16x16" and not rec.get("pod_on_weights"):
        bad.append("the pod axis shards no weight")
    return bad


def mesh_train_phase(torch, dev, tmp: str) -> dict:
    """18a: qwen3-1.7b with the LogicNet-FFN trained 3 steps unsharded,
    then on a (1, 1) mesh with ``--grad-rs``: losses and final parameters
    bit for bit, 252 wgmma masked-matmul launches a step, the masks kept
    after step 1; host ms a step beside the unsharded path's."""
    import gc

    from repro_torch.kernels.masked_matmul import masked_matmul
    from repro_torch.launch import train

    reset_all()
    run = train.build(mesh_train_args(tmp, MESH_STEPS, mesh=False))
    run.loop.run(run.batches, MESH_STEPS)
    plain_losses = [l for _, l in run.loop.metrics]
    plain_ms = 1e3 * statistics.mean(run.step_s[1:])
    plain = {n: p.detach().cpu() for n, p in run.loop.state["params"].items()}
    del run
    gc.collect()
    torch.cuda.empty_cache()

    reset_all()
    t0 = time.perf_counter()
    run = train.build(mesh_train_args(tmp, MESH_STEPS, mesh=True))
    build_s = time.perf_counter() - t0
    cfg, loop = run.cfg, run.loop
    if run.mesh is None or run.mesh.size() != 1:
        fail(f"phase 18a: the run is not on a one-rank mesh ({run.mesh})")
    per_step = LM_MM_PER_LAYER_STEP * cfg.n_layers
    loop.run(run.batches, 1)
    if masked_matmul.launches != per_step:
        fail(f"phase 18a step 1 launched masked_matmul "
             f"{masked_matmul.launches} times, not {per_step}")
    p = {n: mesh_param(t) for n, t in loop.state["params"].items()}
    for i in range(cfg.n_layers):
        for wname, mname in (("wi_gate", "mask_in"), ("wi_up", "mask_in"),
                             ("wo", "mask_out")):
            w, m = p[f"layers.{i}.ffn.{wname}"], p[f"layers.{i}.ffn.{mname}"]
            if bool((w[m == 0] != 0).any()) or bool(
                    (m.sum(0) != cfg.logicnet_ffn.fan_in).any()):
                fail(f"phase 18a layer {i} {wname}: a pruned weight is not "
                     f"0 after step 1, or a mask column does not sum to "
                     f"{cfg.logicnet_ffn.fan_in}")
    loop.run(run.batches, MESH_STEPS)
    torch.cuda.synchronize()
    launches = masked_matmul.launches
    by_route = dict(masked_matmul.launches_by_route)
    if launches != per_step * MESH_STEPS or by_route["wgmma"] != launches:
        fail(f"phase 18a: {launches} masked_matmul launches in "
             f"{MESH_STEPS} steps ({by_route}); expected {per_step} a "
             f"step, all wgmma")
    losses = [l for _, l in loop.metrics]
    if losses != plain_losses:
        fail(f"phase 18a: losses on the mesh {losses} differ from the "
             f"unsharded path's {plain_losses}")
    differ = [n for n, t in loop.state["params"].items()
              if not torch.equal(mesh_param(t).detach().cpu(), plain[n])]
    if differ:
        fail(f"phase 18a: {len(differ)} parameters differ from the "
             f"unsharded path's after {MESH_STEPS} steps: {differ[:4]}")
    mesh_ms = 1e3 * statistics.mean(run.step_s[1:])
    line = train.summary(run)
    print(line, flush=True)
    log(f"phase 18a {cfg.arch_id} --full --logicnet-ffn --model-parallel 1 "
        f"--grad-rs on {train.describe(run.mesh)}: losses {losses} and all "
        f"{len(plain)} parameters bit for bit the unsharded path's; "
        f"masked_matmul {launches} launches ({per_step} a step, "
        f"{by_route}); host ms a step (steps 2-{MESH_STEPS}, synchronised) "
        f"{mesh_ms:.1f} on the mesh against {plain_ms:.1f} unsharded; "
        f"mesh state built in {build_s:.2f} s "
        f"({torch.cuda.get_device_name(0)})")
    out = {"launches": launches, "launches_by_route": by_route,
           "steps": MESH_STEPS, "losses": losses,
           "step_ms": mesh_ms, "unsharded_step_ms": plain_ms,
           "build_s": build_s, "train_line": line}
    del run, loop, p, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_prefill_phase(torch, dev) -> dict:
    """18b: qwen3-1.7b at full width, a 4 x 2048 prefill through
    ``make_prefill_step`` unsharded and on the (1, 1) mesh: 28 wgmma flash
    launches and the same logits bit for bit."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.ctx import activation_sharding

    cfg = get_config("qwen3-1.7b")
    b, s = PREFILL_SHAPE
    rng = np.random.default_rng(18)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    model = steps.init_params(cfg, seed=0, device=dev)
    with torch.no_grad():
        want = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    mesh = make_host_mesh(1)
    policy = SH.ShardingPolicy()
    mesh_model = M.LM(cfg, SH.distribute(model.params, mesh, policy))
    batch = SH.distribute_by_specs(
        {"tokens": tokens}, SH.batch_specs(policy, mesh,
                                           {"tokens": tokens}), mesh)
    reset_all()
    t0 = time.perf_counter()
    with torch.no_grad(), activation_sharding(
            mesh, SH.activation_rules(policy)):
        got = prefill(mesh_model, batch).full_tensor()
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    if launches != cfg.n_layers or by_route["wgmma"] != launches:
        fail(f"phase 18b: {launches} flash launches ({by_route}) for a "
             f"{b} x {s} prefill on the mesh; expected {cfg.n_layers}, "
             f"all wgmma")
    if not torch.equal(got, want):
        fail(f"phase 18b: the mesh prefill's logits differ from the "
             f"unsharded one's (max |diff| "
             f"{(got.float() - want.float()).abs().max().item()})")
    log(f"phase 18b {cfg.arch_id} prefill {b} x {s} on the (1, 1) mesh: "
        f"{launches} flash launches ({by_route}), logits bit for bit the "
        f"unsharded prefill's; {mesh_s:.3f} s on the host clock (first "
        f"mesh call) ({torch.cuda.get_device_name(0)})")
    out = {"launches": launches, "launches_by_route": by_route,
           "mesh_first_s": mesh_s}
    del model, mesh_model, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_tokens_line(stdout: str) -> str | None:
    """The ``[serve] tokens`` line of ``launch.serve``'s LM mode."""
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("[serve] tokens ")]
    return lines[-1] if lines else None


def mesh_serve_phase(torch, dev) -> dict:
    """18c: ``python -m repro_torch.launch.serve --arch qwen3-1.7b --full``
    at its defaults (4 slots, cache 128, 32 steps), unsharded and with
    ``--model-parallel 1``: the same tokens."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen3-1.7b", "--full"]
    out = {}
    for key, extra in (("unsharded", []), ("mesh", ["--model-parallel",
                                                    "1"])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=ROOT, env=env,
                              capture_output=True, text=True,
                              timeout=MESH_SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 18c serve {' '.join(extra)}: rc "
                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("[serve] qwen3")), None)
        out[key] = {"line": line, "tokens": serve_tokens_line(proc.stdout),
                    "wall_s": wall}
        print(line, flush=True)
    if out["mesh"]["tokens"] is None or \
            out["mesh"]["tokens"] != out["unsharded"]["tokens"]:
        fail(f"phase 18c: the mesh's tokens {out['mesh']['tokens']} differ "
             f"from the unsharded run's {out['unsharded']['tokens']}")
    log(f"phase 18c serve --arch qwen3-1.7b --full (4 slots, cache 128, 32 "
        f"steps): the same 128 tokens with and without --model-parallel 1; "
        f"process wall s {out['unsharded']['wall_s']:.1f} / "
        f"{out['mesh']['wall_s']:.1f} ({torch.cuda.get_device_name(0)})")
    return out


MESH_DRYRUN_SCRIPT = """
import json, sys, time
from repro_torch.launch import dryrun
args = dryrun.parse_args([])
out = []
for arch, shape, mp in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mp, args)
    rec["cell_s"] = time.perf_counter() - t0
    out.append(rec)
print(json.dumps(out))
"""


def mesh_dryrun_phase(torch) -> dict:
    """18d: ``dryrun.run_cell`` of qwen3-1.7b x train_4k on 16x16 and
    2x16x16 in a process of its own (the fake process group): both ``ok``
    with collectives, the pod axis on weights in the multi-pod cell; the
    seconds of each (host, abstract: no card)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", MESH_DRYRUN_SCRIPT,
         json.dumps(MESH_DRYRUN)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=MESH_DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 18d dry-run: rc {proc.returncode}\n"
             f"{proc.stderr[-3000:]}")
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    for rec in recs:
        bad = mesh_dryrun_check(rec)
        if bad:
            fail(f"phase 18d {rec['arch']} x {rec['shape']} x "
                 f"{rec['mesh']}: {'; '.join(bad)}")
        log(f"phase 18d dry-run {rec['arch']} x {rec['shape']} x "
            f"{rec['mesh']}: ok, {rec['chips']} fake ranks, per-device "
            f"flops {rec['cost']['flops']:.4e}, collectives "
            f"{rec['collectives']['total']:.4e} B, argument bytes "
            f"{rec['memory']['argument_bytes']}, {rec['cell_s']:.1f} s "
            f"(abstract: meta tensors, fake ranks)")
    return {"cells": [{k: r.get(k) for k in
                       ("arch", "shape", "mesh", "chips", "status",
                        "cell_s", "trace_s", "cost", "memory",
                        "collectives", "pod_on_weights")} for r in recs],
            "wall_s": wall}


def mesh_phases(torch, dev) -> dict:
    """Phase 18: the mesh path on a (1, 1) mesh of this card (18a-18c)
    and the production-mesh dry-run (18d)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_train_")
    try:
        out = {"train": mesh_train_phase(torch, dev, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["prefill"] = mesh_prefill_phase(torch, dev)
    # the one-rank group 18a and 18b started, torn down before the
    # subprocesses start their own
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    out["serve"] = mesh_serve_phase(torch, dev)
    out["dryrun"] = mesh_dryrun_phase(torch)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 18 in {out['phase_s']:.1f} s")
    return out


# -- phase 19: the work spread as the reference spreads it, on one card --
# 19a: model A level 3 served by a tier on two replicas of this card (the
# device repeated: the machine has one) against a tier on one
TIER_DEVICES = ("cuda:0", "cuda:0")
TIER_REQUESTS = 64
# 19c: greedy decode steps after the prefill; host ms a step is the mean
# of the steps after the first EP_TP_DECODE_WARM
EP_TP_DECODE_STEPS = 8
EP_TP_DECODE_WARM = 2
EP_TP_CACHE = 16
# 19d: the dry-run's olmoe and mamba2 train_4k cells at 16x16, beside the
# readings of them when the mesh path gathered the experts and the SSM
# projections whole at every layer (per device TFLOP, collective GB;
# PERF.md section 6)
EP_TP_DRYRUN = (("olmoe-1b-7b", "train_4k", False),
                ("mamba2-370m", "train_4k", False))
GATHERED_WHOLE = {"olmoe-1b-7b": (813.7, 94.11), "mamba2-370m": (200.0, 3.107)}


def tier_shard_check(outs, want, st_one, st_two, seen) -> list:
    """What 19a's two tiers lack: every output equal to ``net(codes)``'s
    (and so to each other's), the one-device tier unsharded, the
    two-replica one sharded over 2 entries with an even bucket, no kernel
    build or compiler run after warmup in either, and each replica's
    launches (``seen``, one dict a replica, of the served requests) all on
    the ``smem`` route of the mixed kernel, one a batch."""
    import numpy as np
    bad = []
    for name, got in outs.items():
        differ = sum(not np.array_equal(g, w) for g, w in zip(got, want))
        if differ or len(got) != len(want):
            bad.append(f"{name}: {differ} of {len(want)} outputs differ "
                       f"from net(codes)")
    if st_one["sharded"] or st_one["n_devices"] != 1:
        bad.append(f"the one-device tier: {st_one['n_devices']} devices, "
                   f"sharded {st_one['sharded']}")
    if not st_two["sharded"] or st_two["n_devices"] != 2 or \
            st_two["bucket_unit"] % 2:
        bad.append(f"the two-replica tier: {st_two['n_devices']} devices, "
                   f"sharded {st_two['sharded']}, bucket unit "
                   f"{st_two['bucket_unit']}")
    for name, st in (("one", st_one), ("two", st_two)):
        if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
            bad.append(f"{name}: {st['retraces_after_warmup']} builds, "
                       f"{st['compiler_runs_after_warmup']} compiler runs "
                       f"after warmup")
    for i, d in enumerate(seen):
        if d != {"lut_network_mixed/smem": st_two["batches"]}:
            bad.append(f"replica {i} launched {d}, not one "
                       f"lut_network_mixed/smem a batch "
                       f"({st_two['batches']})")
    return bad


@contextlib.contextmanager
def count_replica_launches(replicas):
    """While active, each replica's forward (``_apply``: the tier calls it
    once a row shard) adds the LUT kernel launches it makes,
    ``{"<wrapper>/<route>": n}``, to its own dict of the list this
    yields, one a replica."""
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import lut_network, lut_network_mixed

    def now():
        return {f"{w.__name__}/{route}": n
                for w in (lut_network_mixed, lut_network, lut_lookup)
                for route, n in w.launches_by_route.items()}

    def counting(inner, seen):
        def apply(codes):
            before = now()
            out = inner(codes)
            for key, n in now().items():
                if n != before[key]:
                    seen[key] = seen.get(key, 0) + n - before[key]
            return out
        return apply

    # the engine's nets are frozen dataclasses: set and drop the
    # instance's own ``_apply`` past their ``__setattr__``
    seen = [{} for _ in replicas]
    for net, d in zip(replicas, seen):
        object.__setattr__(net, "_apply", counting(net._apply, d))
    try:
        yield seen
    finally:
        for net in replicas:
            object.__delattr__(net, "_apply")


def tier_replicas_phase(torch, dev) -> dict:
    """19a: model A level 3 (``model_a_l3.npz``) served by a tier on
    ``TIER_DEVICES`` and by one on this card alone, on the same 64 ragged
    requests (1-8 rows): codes bit for bit ``net(codes)``'s, the sharded
    tier's stats, no build or compiler run after warmup, each replica's
    launches by route; wall s of each, twice, in turns (host clock)."""
    import asyncio

    import numpy as np

    from repro_torch import engine, serve
    from repro_torch.kernels.lut_network import lut_network_mixed
    net = engine.load(str(FIXTURE / "model_a_l3.npz"), device=dev)
    rng = np.random.default_rng(19)
    reqs = [rng.integers(0, 8, (int(k), net.n_in), dtype=np.int32)
            for k in rng.integers(1, 9, TIER_REQUESTS)]
    want = [net(r).cpu().numpy() for r in reqs]
    torch.cuda.synchronize()

    async def run(devices):
        cfg = serve.TierConfig(max_batch_rows=32, flush_deadline_s=0.002,
                               devices=devices)
        async with serve.ServingTier(net, cfg) as tier:
            with count_replica_launches(tier.replicas) as seen:
                reset_counts(lut_network_mixed)
                t0 = time.perf_counter()
                outs = await asyncio.gather(*[tier.infer(r) for r in reqs])
                wall = time.perf_counter() - t0
                launches = lut_network_mixed.launches
                by_route = dict(lut_network_mixed.launches_by_route)
        return outs, tier.stats(), seen, wall, launches, by_route

    # in turns (one, two, two, one): the first run warms the host's path
    one = asyncio.run(run((str(dev),)))
    two = asyncio.run(run(TIER_DEVICES))
    two_s = [two[3], asyncio.run(run(TIER_DEVICES))[3]]
    one_s = [one[3], asyncio.run(run((str(dev),)))[3]]
    bad = tier_shard_check({"one device": one[0], "two replicas": two[0]},
                           want, one[1], two[1], two[2])
    if two[4] != 2 * two[1]["batches"] or two[5]["smem"] != two[4]:
        bad.append(f"lut_network_mixed launched {two[4]} times "
                   f"({two[5]}) for {two[1]['batches']} batches on 2 "
                   f"replicas")
    if bad:
        fail("phase 19a: " + "; ".join(bad))
    st = two[1]
    log(f"phase 19a model A level 3 through the tier on {TIER_DEVICES}: "
        f"{TIER_REQUESTS} requests ({sum(r.shape[0] for r in reqs)} rows) "
        f"bit for bit net(codes)'s and the one-device tier's; "
        f"{st['batches']} batches, bucket unit {st['bucket_unit']}, "
        f"sharded {st['sharded']}, builds / compiler runs after warmup "
        f"{st['retraces_after_warmup']} / "
        f"{st['compiler_runs_after_warmup']}; lut_network_mixed "
        f"{two[4]} launches ({two[5]}), by replica {two[2]}; wall s in "
        f"turns {one_s[0]:.4f}, {two_s[0]:.4f}, {two_s[1]:.4f}, "
        f"{one_s[1]:.4f} (one device, two replicas, two, one; host clock, "
        f"{torch.cuda.get_device_name(0)})")
    return {"launches": two[4], "launches_by_route": two[5],
            "by_replica": two[2], "batches": st["batches"],
            "bucket_unit": st["bucket_unit"], "wall_s_one": one_s,
            "wall_s_two": two_s}


@contextlib.contextmanager
def record_top_k():
    """While active, every call of the port's MoE top-k (``moe._top_k``:
    inside the router on one device, on each rank's rows on a mesh)
    appends its chosen experts (detached) to the list this yields."""
    from repro_torch.models import moe
    rec: list = []
    inner = moe._top_k

    def top_k(logits, cfg):
        out = inner(logits, cfg)
        rec.append(out[0].detach())
        return out

    moe._top_k = top_k
    try:
        yield rec
    finally:
        moe._top_k = inner


def kept_pairs(torch, topi, cfg):
    """The (token, k) pairs the grouped dispatch keeps of one call's
    choices, as a (G, S, K) mask."""
    from repro_torch.models import moe
    k = cfg.moe.top_k
    flat = topi.reshape(-1, k)
    gs = min(moe.GROUP_TOKENS, flat.shape[0])
    return moe.dense_keep(flat.reshape(-1, gs, k), cfg.moe.n_experts,
                          moe.capacity(cfg, gs))[2].any(-1)


def one_rank_mesh_model(cfg, model, mesh, policy):
    """``model``'s parameters on the (1, 1) mesh (their storage shared: one
    rank's shard is the tensor itself), as a model."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    return M.LM(cfg, SH.distribute(model.params, mesh, policy))


def on_device(torch, dev, fn):
    """``fn()`` (``torch.cuda`` bookkeeping: a sync, a peak reading) on a
    CUDA device; 0 on the CPU, where the CPU tests run 19b and 19c's
    comparisons."""
    return fn() if dev.type == "cuda" else 0


def ep_moe_run(torch, dev, mesh, cfg, shape) -> tuple[list, dict]:
    """19b's runs: ``cfg``'s prefill of ``shape`` unsharded, then (the
    first model's cast dropped: at full width both do not fit with their
    activations) on ``mesh`` through the expert-parallel dispatch, every
    counter at 0 first: ``(what differs: logits, a layer's choices or
    kept (token, k) pairs; readings)``."""
    import gc

    import numpy as np

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.ctx import activation_sharding

    b, s = shape
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (b, s))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    on_device(torch, dev, torch.cuda.reset_peak_memory_stats)
    model = steps.init_params(cfg, seed=0, device=dev)
    with torch.no_grad(), record_top_k() as plain_routes:
        want = prefill(model, {"tokens": tokens})
    peak_plain = on_device(torch, dev, torch.cuda.max_memory_allocated)
    model._cast = None
    gc.collect()
    on_device(torch, dev, torch.cuda.empty_cache)
    on_device(torch, dev, torch.cuda.reset_peak_memory_stats)
    policy = SH.ShardingPolicy()
    mesh_model = one_rank_mesh_model(cfg, model, mesh, policy)
    batch = SH.distribute_by_specs(
        {"tokens": tokens}, SH.batch_specs(policy, mesh,
                                           {"tokens": tokens}), mesh)
    reset_all()
    t0 = time.perf_counter()
    with torch.no_grad(), record_top_k() as mesh_routes, \
            activation_sharding(mesh, SH.activation_rules(policy)):
        got = prefill(mesh_model, batch).full_tensor()
    on_device(torch, dev, torch.cuda.synchronize)
    info = {"launches": flash_attention.launches,
            "launches_by_route": dict(flash_attention.launches_by_route),
            "mesh_first_s": time.perf_counter() - t0,
            "peak_bytes_unsharded": peak_plain,
            "peak_bytes_mesh": on_device(torch, dev,
                                         torch.cuda.max_memory_allocated),
            "pairs": cfg.n_layers * b * s * cfg.moe.top_k, "kept_pairs": 0}
    bad = []
    if not torch.equal(got, want):
        bad.append(f"logits (max |diff| "
                   f"{(got.float() - want.float()).abs().max().item()})")
    if len(mesh_routes) != cfg.n_layers or len(plain_routes) != cfg.n_layers:
        bad.append(f"{len(plain_routes)} / {len(mesh_routes)} router calls, "
                   f"not {cfg.n_layers}")
    for i, (a, c) in enumerate(zip(plain_routes, mesh_routes)):
        ka, kc = kept_pairs(torch, a, cfg), kept_pairs(torch, c, cfg)
        if not torch.equal(a.reshape(c.shape), c) or not torch.equal(ka, kc):
            bad.append(f"layer {i}'s kept (token, k) pairs")
        info["kept_pairs"] += int(ka.sum())
    del model, mesh_model, want, got, plain_routes, mesh_routes
    gc.collect()
    on_device(torch, dev, torch.cuda.empty_cache)
    return bad, info


def ep_moe_phase(torch, dev, mesh) -> dict:
    """19b: olmoe-1b-7b at full width, a 4 x 2048 prefill unsharded and on
    the (1, 1) mesh through the expert-parallel dispatch, one after the
    other: logits and every layer's kept (token, k) pairs bit for bit;
    16 wgmma flash launches on the mesh."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    bad, out = ep_moe_run(torch, dev, mesh, cfg, PREFILL_SHAPE)
    if out["launches"] != cfg.n_layers or \
            out["launches_by_route"]["wgmma"] != cfg.n_layers:
        bad.append(f"{out['launches']} flash launches "
                   f"({out['launches_by_route']}) on the mesh, not "
                   f"{cfg.n_layers} wgmma")
    if bad:
        fail("phase 19b: the expert-parallel prefill's " + ", ".join(bad)
             + " differ from the unsharded one's")
    b, s = PREFILL_SHAPE
    log(f"phase 19b {cfg.arch_id} prefill {b} x {s} on the (1, 1) mesh, "
        f"experts sharded over model ({cfg.moe.n_experts} a rank here): "
        f"logits bit for bit the unsharded prefill's, the same "
        f"{out['kept_pairs']} of {out['pairs']} (token, k) pairs kept in "
        f"{cfg.n_layers} layers; {out['launches']} flash launches "
        f"({out['launches_by_route']}); one after the other, peak "
        f"{out['peak_bytes_unsharded'] / 1e9:.2f} GB unsharded, "
        f"{out['peak_bytes_mesh'] / 1e9:.2f} GB on the mesh; "
        f"{out['mesh_first_s']:.3f} s on the host clock (first mesh call) "
        f"({torch.cuda.get_device_name(0)})")
    return out


def greedy_decode(torch, cfg, model, cache, first, steps_n: int,
                  mesh=None, policy=None, step_s=None):
    """``steps_n`` greedy steps from ``first`` (B, 1) at positions 0, 1,
    ..., as ``launch.serve.lm_decode`` feeds them (on a mesh the tokens
    laid out by ``batch_specs``, the logits gathered whole): the tokens
    (B, steps_n) and the cache.  With a list ``step_s``, each step's
    seconds on the host clock, synchronised, are appended to it."""
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as SH
    step = steps.make_decode_step(cfg)
    tok, out = first, []
    pos = torch.zeros((first.shape[0],), dtype=torch.int32,
                      device=first.device)
    for _ in range(steps_n):
        t0 = time.perf_counter()
        if mesh is not None:
            tok = SH.distribute_by_specs(
                {"tokens": tok}, SH.batch_specs(policy, mesh,
                                                {"tokens": tok}),
                mesh)["tokens"]
        logits, cache = step(model, cache, tok, pos)
        if mesh is not None:
            logits = logits.full_tensor()
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
        pos = pos + 1
        if step_s is not None:
            if first.device.type == "cuda":
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    return torch.cat(out, dim=1), cache


def tp_ssm_run(torch, dev, mesh, cfg, shape, decode_steps: int
               ) -> tuple[list, dict]:
    """19c's runs: ``cfg``'s prefill of ``shape`` and ``decode_steps``
    greedy steps unsharded and on ``mesh`` through the head-parallel
    block (the decode state laid out by ``cache_specs``): ``(what
    differs: logits, tokens, the final SSD state or conv ring;
    readings)``."""
    import gc

    import numpy as np

    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.ctx import activation_sharding
    from repro_torch.parallel.local import local_tensor

    b, s = shape
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (b, s))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    model = steps.init_params(cfg, seed=0, device=dev)
    plain_s, mesh_s = [], []
    with torch.no_grad():
        want = prefill(model, {"tokens": tokens})
        want_toks, want_cache = greedy_decode(
            torch, cfg, model, M.init_cache(cfg, b, EP_TP_CACHE, dev),
            want.argmax(-1, keepdim=True).to(torch.int32), decode_steps,
            step_s=plain_s)
    policy = SH.ShardingPolicy()
    mesh_model = one_rank_mesh_model(cfg, model, mesh, policy)
    batch = SH.distribute_by_specs(
        {"tokens": tokens}, SH.batch_specs(policy, mesh,
                                           {"tokens": tokens}), mesh)
    cache = M.init_cache(cfg, b, EP_TP_CACHE, dev)
    cache = SH.distribute_by_specs(cache, SH.cache_specs(policy, mesh,
                                                         cache), mesh)
    reset_all()
    t0 = time.perf_counter()
    with torch.no_grad(), activation_sharding(
            mesh, SH.activation_rules(policy)):
        got = prefill(mesh_model, batch).full_tensor()
        toks, cache = greedy_decode(
            torch, cfg, mesh_model, cache,
            got.argmax(-1, keepdim=True).to(torch.int32), decode_steps,
            mesh, policy, step_s=mesh_s)
    on_device(torch, dev, torch.cuda.synchronize)
    warm = min(EP_TP_DECODE_WARM, decode_steps - 1)
    info = {"tokens": toks.tolist(), "mesh_first_s": time.perf_counter() - t0,
            "placements": {k: str(tuple(v.placements))
                           for k, v in cache["ssm"].items()},
            "decode_host_ms_unsharded": 1e3 * statistics.mean(
                plain_s[warm:]),
            "decode_host_ms_mesh": 1e3 * statistics.mean(mesh_s[warm:])}
    bad = []
    if not torch.equal(got, want):
        bad.append(f"prefill logits (max |diff| "
                   f"{(got.float() - want.float()).abs().max().item()})")
    if not torch.equal(toks, want_toks):
        bad.append(f"tokens {toks.tolist()} against {want_toks.tolist()}")
    for key in ("ssd", "conv"):
        if not torch.equal(local_tensor(cache["ssm"][key]),
                           want_cache["ssm"][key]):
            bad.append(f"the final {key} state")
    del model, mesh_model, want, got, cache, want_cache
    gc.collect()
    on_device(torch, dev, torch.cuda.empty_cache)
    return bad, info


def tp_ssm_phase(torch, dev, mesh) -> dict:
    """19c: mamba2-370m at full width, a 4 x 2048 prefill and 8 greedy
    decode steps unsharded and on the (1, 1) mesh through the
    head-parallel block: logits, tokens and the final SSD state and conv
    ring bit for bit."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    bad, out = tp_ssm_run(torch, dev, mesh, cfg, PREFILL_SHAPE,
                          EP_TP_DECODE_STEPS)
    if bad:
        fail("phase 19c: the head-parallel path's " + ", ".join(bad)
             + " differ from the unsharded path's")
    b, s = PREFILL_SHAPE
    log(f"phase 19c {cfg.arch_id} prefill {b} x {s} and "
        f"{EP_TP_DECODE_STEPS} greedy decode steps on the (1, 1) mesh, "
        f"heads over model (all 32 on the one rank here): logits, "
        f"{b * EP_TP_DECODE_STEPS} tokens and the final SSD state and conv "
        f"ring bit for bit the unsharded path's (state placements "
        f"{out['placements']}); {out['mesh_first_s']:.3f} s on the host "
        f"clock (first mesh calls); a decode step "
        f"{out['decode_host_ms_mesh']:.3f} ms on the mesh, "
        f"{out['decode_host_ms_unsharded']:.3f} ms unsharded (host clock, "
        f"synchronised, mean of steps {EP_TP_DECODE_WARM + 1}-"
        f"{EP_TP_DECODE_STEPS}) ({torch.cuda.get_device_name(0)})")
    return out


def ep_tp_dryrun_line(rec: dict) -> str:
    """19d's line for one dry-run record: per device TFLOP and collective
    GB beside the figures with the weights gathered whole."""
    tflop = rec["cost"]["flops"] / 1e12
    coll = rec["collectives"]["total"] / 1e9
    was = GATHERED_WHOLE[rec["arch"]]
    kinds = ", ".join(f"{k} {rec['collectives'][k] / 1e9:.4g}"
                      for k in ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all") if k in rec["collectives"])
    return (f"{rec['arch']} x {rec['shape']} x {rec['mesh']}: ok, per "
            f"device {tflop:.4g} TFLOP (weights gathered whole: {was[0]}), "
            f"collectives {coll:.4g} GB ({kinds}; gathered whole: "
            f"{was[1]}), "
            f"{rec['cell_s']:.1f} s")


def ep_tp_dryrun_phase(torch) -> dict:
    """19d: ``dryrun.run_cell`` of olmoe-1b-7b and mamba2-370m x train_4k
    at 16x16 (fake ranks, meta tensors) in a process of its own: ``ok``,
    and fewer FLOPs a device than with the weights gathered whole."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-c", MESH_DRYRUN_SCRIPT, json.dumps(EP_TP_DRYRUN)],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=MESH_DRYRUN_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"phase 19d dry-run: rc {proc.returncode}\n"
             f"{proc.stderr[-3000:]}")
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    for rec in recs:
        bad = mesh_dryrun_check(rec)
        if not bad and rec["cost"]["flops"] / 1e12 >= \
                GATHERED_WHOLE[rec["arch"]][0]:
            bad.append("no fewer FLOPs a device than with the weights "
                       "gathered whole")
        if bad:
            fail(f"phase 19d {rec['arch']} x {rec['shape']} x "
                 f"{rec['mesh']}: {'; '.join(bad)}")
        log(f"phase 19d dry-run {ep_tp_dryrun_line(rec)} (abstract: meta "
            f"tensors, fake ranks)")
    return {"cells": [{k: r.get(k) for k in
                       ("arch", "shape", "mesh", "chips", "status",
                        "cell_s", "cost", "collectives")} for r in recs]}


def ep_tp_phases(torch, dev) -> dict:
    """Phase 19: the tier's replicas (19a), the expert-parallel MoE (19b)
    and the head-parallel SSM (19c) on a (1, 1) mesh of this card, and
    the dry-run's cells (19d)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    out = {"tier": tier_replicas_phase(torch, dev)}
    mesh = make_host_mesh(1)
    out["moe"] = ep_moe_phase(torch, dev, mesh)
    out["ssm"] = tp_ssm_phase(torch, dev, mesh)
    if dist.is_initialized():
        dist.destroy_process_group()
    out["dryrun"] = ep_tp_dryrun_phase(torch)
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 19 in {out['phase_s']:.1f} s")
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

    def layer_chain(net, route=None, layers=None):
        """A per-layer forward: through the wrapper (counted) when
        ``route`` is None; else every launch called directly, uncounted, on
        ``route``: "smem" or "direct" forced."""
        layers = layers or net.layers

        def call(c):
            for idx, tab, bw in layers:
                if route is None:
                    c = lut_lookup(c, idx, tab, bw)
                    continue
                out = torch.empty((c.shape[0], idx.shape[0]),
                                  dtype=torch.int32, device=dev)
                if c.shape[0]:
                    geom = lut_lookup_mod.lut_layer_route(
                        c.shape[0], c.shape[1], idx.shape[0], idx.shape[1],
                        tab.shape[1], sms, tab.element_size(), route=route)
                    lut_lookup_mod._launch_layer(c, idx, tab, bw, out, geom)
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
        # the record keeps the per-layer kernel's name of earlier runs; its
        # entry is lut_layer_smem_forward
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
        """A per-layer forward's times at TIME_BATCHES: event ms,
        device-paced ms (twice), profiler device ms, the plain version and
        the bound."""
        net, n_call = k["net"], k["per_call"]
        rec = {"layers": n_call}
        for b in TIME_BATCHES:
            codes = k["codes"][:b].contiguous()
            iters = 200 if b <= 16 else 50
            sfx = "" if b == TIME_BATCHES[0] else f"_b{b}"
            turns = [paced_ms(lambda: k["kernel"](codes)) for _ in range(2)]
            paced = None if None in turns else statistics.mean(turns)
            ms = cuda_ms(lambda: k["kernel"](codes), iters)
            plain_ms = cuda_ms(lambda: k["plain"](codes), iters)
            dev_ms = device_ms(lambda: k["kernel"](codes), iters, n_call)
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
                f"paced_ms{sfx}": paced,
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
                f"device-paced {paced} ms a forward (turns {turns}), event "
                f"{ms:.5f} ms, device {dev_ms} ms, plain {plain_ms:.5f} ms, "
                f"bound "
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
    fa["lm_smoke_max_abs"].update(moe_ssm_smoke_phase(torch, dev))
    fa["lm_smoke_max_abs"].update(encdec_vlm_smoke_phase(torch, dev))
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
    train_times = flash_train_times(torch, dev)
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

    # -- phase 13: the quickstart, RTL against the kernels, the tables
    from repro_torch.kernels.masked_matmul import masked_matmul
    p13_wrappers = (lut_network_mixed, lut_network, lut_lookup,
                    masked_matmul)
    quick = quickstart_phase(torch, dev, p13_wrappers)
    rtl = rtl_phase(torch, dev, triples, triples_d, p13_wrappers)
    tables_out = tables_phase(torch, dev, p13_wrappers)
    for rec in records:
        for key, launches in (("quickstart", quick["launches"]),
                              ("paper_tables", tables_out["launches"])):
            if rec["name"] in launches:
                rec[f"launches_{key}"] = launches[rec["name"]]["launches"]
                rec[f"launches_{key}_by_route"] = launches[rec["name"]][
                    "by_route"]
    layer_rec["rtl"] = {k: v for k, v in rtl.items() if k == "D-raw"}
    mixed_rec["rtl"] = {k: v for k, v in rtl.items() if k.startswith("A@")}
    mixed_rec["rtl"]["optimize_s"] = rtl["optimize_s"]
    mm_rec["paper_tables_walls_s"] = tables_out["walls"]

    # -- phase 14: qwen3-1.7b trained with the LogicNet-FFN, served,
    # checkpointed and restarted; its masked products on the wgmma route
    records.append(lm_train_phases(torch, dev))
    # training attention's two kernels: phase 10's checks and times, and
    # their launches on phase 14b's main path
    attn = records[-1]["lm_training"]["attn_launches"]
    for name, source, half, keys in (
            ("flash_attention_wgmma_forward_train", FA_WGMMA_SOURCE,
             "forward", ("train_",)),
            ("flash_attention_wgmma_backward", FA_BWD_SOURCE, "backward",
             ("bwd_", "train_check", "train_shape"))):
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": None, "reference": FA_TRAIN_REFERENCE,
               "launches": attn[half][0],
               "launches_by_route": attn[half][1]}
        rec.update({k: v for k, v in train_times.items()
                    if k.startswith(keys)})
        records.append(rec)

    # -- phase 15: the MoE and SSM families at full width; flash's launches
    # on their paths (mamba2-370m has no attention) and its times at their
    # head shapes
    families = lm_family_phases(torch, dev)
    for key, arch in (("moe", "olmoe-1b-7b"), ("hybrid", "zamba2-2.7b"),
                      ("ssm", "mamba2-370m")):
        fa_rec[f"launches_{key}"] = families[arch]["launches"]
        fa_rec[f"launches_{key}_checks"] = families[arch]["check_launches"]
    fa_rec["lm_families"] = families

    # -- phase 16: the encoder-decoder and M-RoPE families at full width;
    # whisper's encoder and cross-attention run the tf32x3 kernel (float32,
    # as in the reference), its decoder and qwen2-vl the wgmma one
    encdec = lm_encdec_phases(torch, dev)
    for key, arch in (("whisper", "whisper-medium"),
                      ("qwen2_vl", "qwen2-vl-2b")):
        routes = encdec[arch]["launches_by_route"]
        fa_rec[f"launches_{key}"] = routes["wgmma"] + routes["simt"]
        tf_rec[f"launches_{key}"] = routes["tf32x3"]
        fa_rec[f"launches_{key}_checks"] = encdec[arch]["check_launches"]
    fa_rec["lm_encdec_vlm"] = {k: v for k, v in encdec.items()
                               if k != "flash"}
    fa_rec["cross_shapes"] = {k: v for k, v in encdec["flash"].items()
                              if v["route"] == "wgmma"}
    tf_rec["cross_shapes"] = {k: v for k, v in encdec["flash"].items()
                              if v["route"] == "tf32x3"}

    # -- phase 17: the families trained; the LogicNet-FFN's products on
    # the wgmma route at zamba2's and qwen2-vl's widths
    trained = train_families_phase(torch, dev)
    ffn_rec = next(r for r in records
                   if r["name"] == "masked_matmul_wgmma_forward")
    for key, arch in (("zamba2", "zamba2-2.7b"), ("qwen2_vl", "qwen2-vl-2b")):
        ffn_rec[f"launches_train_{key}"] = trained["full"][arch]["launches"]
        ffn_rec[f"shapes_train_{key}"] = trained["ffn_times"][arch]
    smoke_routes: dict[str, int] = {}
    for r in trained["smoke"].values():
        for route, n in r["masked_matmul_launches"].items():
            smoke_routes[route] = smoke_routes.get(route, 0) + n
    ffn_rec["launches_train_smoke_by_route"] = smoke_routes
    ffn_rec["train_families"] = {k: v for k, v in trained.items()
                                 if k != "ffn_times"}

    # -- phase 18: the mesh path (torch.distributed, DTensor) on a (1, 1)
    # mesh of this card, and the production-mesh dry-run
    mesh = mesh_phases(torch, dev)
    ffn_rec["launches_mesh"] = mesh["train"]["launches"]
    ffn_rec["launches_mesh_by_route"] = mesh["train"]["launches_by_route"]
    fa_rec["launches_mesh"] = mesh["prefill"]["launches"]
    fa_rec["launches_mesh_by_route"] = mesh["prefill"]["launches_by_route"]
    ffn_rec["mesh"] = mesh

    # -- phase 19: the tier's data-parallel replicas, the expert-parallel
    # MoE and the head-parallel SSM on a (1, 1) mesh, the dry-run's cells
    spread = ep_tp_phases(torch, dev)
    mixed_rec["launches_tier_replicas"] = spread["tier"]["launches"]
    mixed_rec["launches_tier_replicas_by_replica"] = spread["tier"][
        "by_replica"]
    fa_rec["launches_ep_mesh"] = spread["moe"]["launches"]
    fa_rec["launches_ep_mesh_by_route"] = spread["moe"]["launches_by_route"]
    mixed_rec["spread"] = spread

    log(f"chip_smoke.py ran {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
