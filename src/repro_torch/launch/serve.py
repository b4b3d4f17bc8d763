"""Serving launcher: ``python -m repro_torch.launch.serve``.

Two serving stacks behind one CLI, as the reference's.

* ``--lut`` — loads a saved ``CompiledLUTNet`` artifact (either
package's), or without ``--artifact`` compiles generated fpga4hep model
A through the truth-table compiler (``--optimize-level``, default 3;
``--autotune`` times every plan variant on the device and serves the
winner), and drives it through the
``repro_torch.serve`` micro-batching tier under closed-loop
(or ``--open-loop RPS``) load, reporting p50/p99 latency, QPS, batch
occupancy and the compile-once counters, with the reference CLI's report
lines::

    # serve the model A level-3 artifact on the card
    python -m repro_torch.launch.serve --lut \\
        --artifact tests/fixtures/torch_port/model_a_l3.npz --input-bw 3

    # compile generated model A at level 3 and serve it (layout mixed)
    python -m repro_torch.launch.serve --lut --optimize-level 3

    # put the HTTP ingress in front (0 = ephemeral port): one verified
    # open-loop run through it, or, without --smoke / --open-loop, serve
    # until SIGTERM with a per-tenant row quota
    python -m repro_torch.launch.serve --lut --http 0 --smoke
    python -m repro_torch.launch.serve --lut --http 8080 \\
        --tenant-quota 500:1000

    # time every plan variant on the card and serve the measured winner
    python -m repro_torch.launch.serve --lut --autotune --smoke

    # quick smoke on the CPU (plain PyTorch versions of the kernels)
    python -m repro_torch.launch.serve --lut --smoke --device cpu

  Exits non-zero if the compile-once contract is broken in steady state.

* default (no ``--lut``) — the LM decode demo (:func:`_run_lm`): batched
  greedy decode of ``--arch`` (the smoke config, or ``--full``'s
  published one), weights from seed 0, ``--slots`` rows from a ones token
  at position 0 for ``--steps`` steps against a ``--cache-len`` cache,
  and the reference's ``[serve] ... ms/step`` line.  ``--model-parallel
  N`` (or a start under ``torchrun``) puts the weights and the cache on a
  ``(world // N, N)`` mesh by the sharding rules; otherwise it runs on one
  device.  The continuous-batching LM server is ``launch.serve_lm``::

      python -m repro_torch.launch.serve --arch qwen3-1.7b --full
      python -m repro_torch.launch.serve --arch qwen3-1.7b --full \
          --model-parallel 1
      python -m repro_torch.launch.serve --arch qwen3-1.7b --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import signal
import threading
import time


def lm_decode(args: argparse.Namespace, cfg=None, model=None,
              on_token=None) -> dict:
    """The LM mode's decode loop: ``{"cfg", "tokens": (steps, slots)
    greedy tokens, "logits": each step's (slots, vocab) logits when
    ``on_token`` is None, "ms_per_step", "mesh"}``; ``on_token(step,
    logits)`` sees each step's logits instead of keeping them.  ``cfg``
    and ``model`` (its weights; the flags' config at seed 0 by default)
    let a caller serve other weights through the same loop."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import (describe, make_host_mesh,
                                         mesh_device, under_torchrun)
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.ctx import activation_sharding

    if cfg is None:
        cfg = (get_config(args.arch) if args.full
               else get_smoke_config(args.arch))
    mesh = None
    if args.model_parallel is not None or under_torchrun():
        mesh = make_host_mesh(args.model_parallel or 1, device=args.device)
        dev = mesh_device(mesh)
    else:
        from repro_torch._device import resolve_device
        dev = resolve_device(args.device)
    if model is None:
        model = S.init_params(cfg, seed=0, device=dev)
    cache = M.init_cache(cfg, args.slots, args.cache_len, device=dev)
    ctx = None
    if mesh is not None:
        policy = SH.ShardingPolicy()
        model = M.LM(cfg, SH.distribute(model.params, mesh, policy))
        cache = SH.distribute_by_specs(
            cache, SH.cache_specs(policy, mesh, cache), mesh)
        ctx = activation_sharding(mesh, SH.activation_rules(policy))
    step = S.make_decode_step(cfg)
    tok = torch.ones((args.slots, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((args.slots,), dtype=torch.int32, device=dev)
    if mesh is not None:
        tok = SH.distribute_by_specs(
            {"tokens": tok}, SH.batch_specs(policy, mesh, {"tokens": tok}),
            mesh)["tokens"]
    tokens, logits_out = [], []
    t0 = time.perf_counter()
    with torch.no_grad(), (ctx or contextlib.nullcontext()):
        for i in range(args.steps):
            logits, cache = step(model, cache, tok, pos)
            if mesh is not None:
                logits = logits.full_tensor()
            if on_token is not None:
                on_token(i, logits)
            else:
                logits_out.append(logits)
            nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            tokens.append(nxt[:, 0])
            tok = nxt
            if mesh is not None:
                tok = SH.distribute_by_specs(
                    {"tokens": tok}, SH.batch_specs(policy, mesh,
                                                    {"tokens": tok}),
                    mesh)["tokens"]
            pos = pos + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return {"cfg": cfg, "tokens": torch.stack(tokens).cpu(),
            "logits": logits_out,
            "ms_per_step": 1e3 * dt / max(args.steps, 1),
            "mesh": describe(mesh) if mesh is not None else None}


def _run_lm(args: argparse.Namespace) -> None:
    """Batched LM decode demo (the pre-LUT serving loop): the reference's
    ``[serve]`` line (a one-device run names no mesh)."""
    out = lm_decode(args, on_token=lambda i, lg: None)
    where = (f" on mesh {out['mesh']}" if out["mesh"] is not None
             else " on one device")
    print(f"[serve] {out['cfg'].arch_id}: {args.steps} decode steps x "
          f"{args.slots} slots{where} ({out['ms_per_step']:.1f} ms/step)")
    print("[serve] tokens " + json.dumps(out["tokens"].tolist()))


def _print_report(rep, st: dict) -> None:
    """The operator-facing LoadReport + tier-counter dump."""
    if rep.n_clients == 0:
        print(f"[serve --lut] {rep.n_requests} open-loop requests offered "
              f"at {rep.offered_rps:.0f} rps in {rep.wall_s:.2f}s: "
              f"outcomes={rep.outcomes}, goodput={rep.goodput_rps:.0f} rps, "
              f"rejection_rate={rep.rejection_rate:.2f}")
    else:
        print(f"[serve --lut] {rep.n_requests} requests ({rep.rows} rows) "
              f"from {rep.n_clients} closed-loop clients in {rep.wall_s:.2f}s")
    print(f"[serve --lut] latency p50={rep.p50_ms:.2f}ms "
          f"p90={rep.p90_ms:.2f}ms p99={rep.p99_ms:.2f}ms "
          f"mean={rep.mean_ms:.2f}ms; qps={rep.qps:.0f} "
          f"({rep.rows_per_sec:.0f} rows/s)")
    if st:
        print(f"[serve --lut] {st['batches']} batches, occupancy "
              f"{st['batch_occupancy']:.2f} (mean "
              f"{st['mean_batch_rows']:.1f} rows), "
              f"flushes={st['flush_causes']}, {st['n_devices']} device(s)"
              f"{' sharded' if st['sharded'] else ''}")
    for stage in ("queue_wait", "assembly", "device"):
        leg = rep.breakdown.get(stage)
        if leg and leg["count"]:
            print(f"[serve --lut] {stage}: mean={leg['mean_ms']:.2f}ms "
                  f"p50={leg['p50_ms']:.2f}ms p99={leg['p99_ms']:.2f}ms")


def _print_plan(net) -> None:
    """An autotuned plan's line: its timings where this package took them
    on this device, else only where it came from."""
    plan = net.plan
    if plan.source != "autotune":
        return
    us = plan.timings_us
    if not net.measured_here:
        print(f"[serve --lut] plan {plan.variant.key} (source autotune, "
              f"backend {plan.backend or 'not recorded'}) replayed as "
              f"saved: timings not taken on this device ({net.device})")
        return
    key = plan.variant.key
    print(f"[serve --lut] autotuned on {plan.backend} over {len(us)} "
          f"variants at {plan.batch} rows: chose {key} "
          f"({us[key]:.1f} us/forward, route {plan.routes.get(key)}) vs "
          f"heuristic {plan.default_key} at {us[plan.default_key]:.1f} us; "
          f"save the artifact to replay this plan with zero search")


def _build_net(args: argparse.Namespace):
    """Load ``--artifact`` or compile generated fpga4hep model A.

    Model A is made as the reference's CLI makes it (a seeded init, one
    ``train=True`` forward over 256 rows uniform in [-1, 3) for the
    batch-norm statistics, ``generate_tables``), from ``torch.Generator``
    seeds 0 and 1, so its tables are not the reference's.  Returns the
    net and the request code width.
    """
    import torch

    from repro_torch import engine

    if args.artifact:
        net = engine.load(args.artifact, device=args.device)
        print(f"[serve --lut] loaded {args.artifact}: layout={net.layout} "
              f"n_in={net.n_in} n_out={net.n_out} "
              f"table slab {net.slab_breakdown()['table_slab_bytes']} B "
              f"on {net.device} "
              f"(compiler runs this process: {engine.compile_runs()})")
        _print_plan(net)
        # the artifact does not record its input quantizer width
        return net, args.input_bw
    from repro_torch._device import resolve_device
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN

    dev = resolve_device(args.device)
    cfg = fpga4hep.model_a()
    model = LN.init(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.rand((256, cfg.in_features),
                   generator=torch.Generator().manual_seed(1)) * 4 - 1
    with torch.no_grad():
        LN.forward(model, x, train=True)
    tables = LN.generate_tables(model)
    net = engine.compile_network(tables, optimize_level=args.optimize_level,
                                 in_features=cfg.in_features,
                                 block_b=args.block_b,
                                 autotune=args.autotune, device=dev)
    print(f"[serve --lut] compiled generated fpga4hep model A at level "
          f"{args.optimize_level}: layout={net.layout}, table slab "
          f"{net.slab_breakdown()['table_slab_bytes']} B on {net.device}")
    _print_plan(net)
    return net, cfg.bw


def _parse_quota(spec: str | None):
    """``--tenant-quota RATE[:BURST]`` -> QuotaConfig (rows/s) or None."""
    from repro_torch import serve

    if spec is None:
        return None
    rate, _, burst = spec.partition(":")
    return serve.QuotaConfig(rate_rows_per_s=float(rate),
                             burst_rows=float(burst) if burst else None)


def _dump_report(args: argparse.Namespace, rep) -> None:
    if args.report_json:
        with open(args.report_json, "w") as fh:
            json.dump(rep.as_dict(), fh, indent=2, default=str)
        print(f"[serve --lut] load report -> {args.report_json}")


def _run_http(args: argparse.Namespace, net, bw, tier_cfg) -> dict:
    """HTTP ingress mode: one open-loop run through it, verified bit-exact
    (``--smoke`` / ``--open-loop``), or serve until SIGTERM."""
    from repro_torch import serve

    cfg = serve.IngressConfig(port=args.http, quota=_parse_quota(
        args.tenant_quota))
    ing = serve.BackgroundIngress(net, tier_cfg, cfg).start()
    try:
        print(f"[serve --lut] http ingress listening on {ing.url} "
              f"(POST /v1/infer, GET /healthz, GET /metrics)", flush=True)
        if args.smoke or args.open_loop is not None:
            offered = args.open_loop if args.open_loop is not None else 400.0
            rep = serve.run_open_loop(
                url=ing.url, offered_rps=offered,
                n_requests=args.clients * args.requests_per_client,
                rows_min=args.rows_min, rows_max=args.rows_max, bw=bw,
                seed=args.seed, verify_net=net)
            print("[serve --lut] responses verified bit-exact over HTTP")
            _print_report(rep, ing.stats())
            _dump_report(args, rep)
        else:
            stop = threading.Event()

            def _drain(signum, frame):
                print(f"[serve --lut] signal {signum}: draining",
                      flush=True)
                stop.set()

            prev = [signal.signal(s, _drain)
                    for s in (signal.SIGTERM, signal.SIGINT)]
            try:
                while not stop.wait(0.5):
                    pass
            finally:
                for s, h in zip((signal.SIGTERM, signal.SIGINT), prev):
                    signal.signal(s, h)
    finally:
        ing.stop()                      # graceful drain
    return ing.stats()


def _run_lut(args: argparse.Namespace) -> None:
    """Load or compile the net and drive it through the tier, optionally
    behind the HTTP ingress.

    ``--metrics-json`` dumps in a ``finally`` so a run killed by SIGTERM
    still leaves its snapshot (SIGTERM is re-pointed at ``SystemExit``);
    the HTTP serve-forever mode instead catches SIGTERM for a graceful
    drain.
    """
    from repro_torch import obs, serve

    def _term(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _term)
    net, bw = _build_net(args)
    if args.smoke:
        args.clients, args.requests_per_client = 4, 4
    tier_cfg = serve.TierConfig(
        max_batch_rows=args.max_batch_rows,
        flush_deadline_s=args.flush_deadline_ms * 1e-3,
        max_queue_rows=args.max_queue_rows,
        request_timeout_s=(None if args.request_timeout_ms is None
                           else args.request_timeout_ms * 1e-3))
    load = dict(rows_min=args.rows_min, rows_max=args.rows_max,
                bw=bw, seed=args.seed)
    try:
        with obs.PeriodicReporter(interval_s=args.report_every_s):
            if args.http is not None:
                st = _run_http(args, net, bw, tier_cfg)
            else:
                if args.open_loop is not None:
                    rep = serve.run_open_loop(
                        net, config=tier_cfg, offered_rps=args.open_loop,
                        n_requests=args.clients * args.requests_per_client,
                        **load)
                else:
                    rep = serve.run_closed_loop(
                        net, config=tier_cfg, n_clients=args.clients,
                        n_per_client=args.requests_per_client, **load)
                st = rep.stats
                _print_report(rep, st)
                _dump_report(args, rep)
        print(f"[serve --lut] compile-once contract: "
              f"retraces={st['retraces_after_warmup']} "
              f"compiler_runs={st['compiler_runs_after_warmup']} "
              f"after warmup")
        print("[serve --lut]", obs.summary_line())
    finally:
        if args.metrics_json:
            obs.registry().dump_json(args.metrics_json)
            print(f"[serve --lut] metrics snapshot -> {args.metrics_json}",
                  flush=True)
    if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
        raise SystemExit("compile-once contract violated in steady state")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lut", action="store_true",
                    help="serve a CompiledLUTNet through the micro-batching "
                    "tier (without it: the LM decode demo)")
    ap.add_argument("--artifact", default=None, metavar="NPZ",
                    help="saved CompiledLUTNet .npz to serve (default: "
                    "compile generated fpga4hep model A)")
    ap.add_argument("--optimize-level", type=int, default=3,
                    help="truth-table compiler level when compiling")
    ap.add_argument("--block-b", type=int, default=16,
                    help="engine batch bucket when compiling")
    ap.add_argument("--autotune", action="store_true",
                    help="when compiling, time every eligible plan variant "
                    "(layout x block_b x pack) on the device and serve the "
                    "measured winner; the tier then buckets on the plan's "
                    "block_b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop concurrent clients")
    ap.add_argument("--requests-per-client", type=int, default=16)
    ap.add_argument("--rows-min", type=int, default=1)
    ap.add_argument("--rows-max", type=int, default=8,
                    help="request batch rows are uniform in [min, max]")
    ap.add_argument("--max-batch-rows", type=int, default=None,
                    help="tier size-flush threshold (default: block_b)")
    ap.add_argument("--flush-deadline-ms", type=float, default=2.0,
                    help="tier deadline flush for partial batches")
    ap.add_argument("--max-queue-rows", type=int, default=4096,
                    help="bounded-queue backpressure limit")
    ap.add_argument("--request-timeout-ms", type=float, default=None,
                    help="per-request launch deadline (default: none)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="put the HTTP ingress in front of the tier on "
                    "this port (0 = ephemeral; the bound port is printed). "
                    "With --smoke/--open-loop: one verified open-loop run "
                    "through the ingress; otherwise serve until SIGTERM "
                    "with a graceful drain")
    ap.add_argument("--tenant-quota", default=None, metavar="RATE[:BURST]",
                    help="per-tenant token-bucket admission quota in "
                    "rows/s (burst defaults to one second of rate); "
                    "requests over quota get HTTP 429")
    ap.add_argument("--open-loop", type=float, default=None, metavar="RPS",
                    help="use the open-loop Poisson-arrival generator at "
                    "this offered load instead of closed-loop clients "
                    "(total requests stays clients * requests-per-client)")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="dump the LoadReport as JSON")
    ap.add_argument("--input-bw", type=int, default=2,
                    help="synthetic request code width for --artifact "
                    "(codes are uniform in [0, 2**bw); the artifact does "
                    "not record it; a compiled model A uses its own 3)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny load (4 clients x 4 requests)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the obs metrics snapshot as JSON on exit")
    ap.add_argument("--report-every-s", type=float, default=5.0,
                    help="periodic one-line stats report interval while "
                    "the load runs (0 disables)")
    # LM mode
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full published config "
                    "(default: its smoke config)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="decode on a (world // N, N) mesh (default: one "
                    "device, unless under torchrun)")
    args = ap.parse_args(argv)
    if args.lut:
        _run_lut(args)
    else:
        _run_lm(args)


if __name__ == "__main__":
    main()
