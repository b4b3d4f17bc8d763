"""Serving launcher: ``python -m repro_torch.launch.serve --lut``.

Loads a saved ``CompiledLUTNet`` artifact (either package's), or without
``--artifact`` compiles generated fpga4hep model A through the truth-table
compiler (``--optimize-level``, default 3), and drives it through the
``repro_torch.serve`` micro-batching tier under closed-loop
(or ``--open-loop RPS``) load, reporting p50/p99 latency, QPS, batch
occupancy and the compile-once counters, with the reference CLI's report
lines::

    # serve the model A level-3 artifact on the card
    python -m repro_torch.launch.serve --lut \\
        --artifact tests/fixtures/torch_port/model_a_l3.npz --input-bw 3

    # compile generated model A at level 3 and serve it (layout mixed)
    python -m repro_torch.launch.serve --lut --optimize-level 3

    # quick smoke on the CPU (plain PyTorch versions of the kernels)
    python -m repro_torch.launch.serve --lut --smoke --device cpu

The HTTP ingress, ``--autotune`` and the LM decode demo of
``repro.launch.serve`` wait for later slices.
Exits non-zero if the compile-once contract is broken in steady state.
"""

from __future__ import annotations

import argparse
import json
import signal


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
    print(f"[serve --lut] {st['batches']} batches, occupancy "
          f"{st['batch_occupancy']:.2f} (mean "
          f"{st['mean_batch_rows']:.1f} rows), "
          f"flushes={st['flush_causes']}, {st['n_devices']} device(s)")
    for stage in ("queue_wait", "assembly", "device"):
        leg = rep.breakdown.get(stage)
        if leg and leg["count"]:
            print(f"[serve --lut] {stage}: mean={leg['mean_ms']:.2f}ms "
                  f"p50={leg['p50_ms']:.2f}ms p99={leg['p99_ms']:.2f}ms")


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
                                 block_b=args.block_b, device=dev)
    print(f"[serve --lut] compiled generated fpga4hep model A at level "
          f"{args.optimize_level}: layout={net.layout}, table slab "
          f"{net.slab_breakdown()['table_slab_bytes']} B on {net.device}")
    return net, cfg.bw


def _run_lut(args: argparse.Namespace) -> None:
    """Load or compile the net and drive it through the tier.

    ``--metrics-json`` dumps in a ``finally`` so a run killed by SIGTERM
    still leaves its snapshot (SIGTERM is re-pointed at ``SystemExit``).
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
        if args.report_json:
            with open(args.report_json, "w") as fh:
                json.dump(rep.as_dict(), fh, indent=2, default=str)
            print(f"[serve --lut] load report -> {args.report_json}")
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
    ap.add_argument("--lut", action="store_true", required=True,
                    help="serve a CompiledLUTNet through the micro-batching "
                    "tier (the only mode of the port so far)")
    ap.add_argument("--artifact", default=None, metavar="NPZ",
                    help="saved CompiledLUTNet .npz to serve (default: "
                    "compile generated fpga4hep model A)")
    ap.add_argument("--optimize-level", type=int, default=3,
                    help="truth-table compiler level when compiling")
    ap.add_argument("--block-b", type=int, default=16,
                    help="engine batch bucket when compiling")
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
    _run_lut(ap.parse_args(argv))


if __name__ == "__main__":
    main()
