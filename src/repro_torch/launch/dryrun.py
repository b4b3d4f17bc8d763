"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh, with no device.

The port of ``repro.launch.dryrun``.  The reference fakes 512 XLA host
devices and lowers + compiles each cell; here one process is rank 0 of a
``fake`` process group of 256 or 512 ranks (``launch.mesh.
make_production_mesh``), every tensor is a ``meta`` tensor laid out as a
DTensor by the sharding rules, and the step (train, prefill or decode,
the port's ``launch.steps``) runs eagerly on this rank's local shards: a
failure (a sharding the model cannot run, an op DTensor has no rule for)
is a bug in the system, not in the script.  The kernel wrappers compute
their plain versions' shapes (``_device.abstract_run``).

Per cell, a record with the reference's mesh-free fields (``kind``,
``params``, ``active_params``, ``seq_len``, ``global_batch``, ``status``,
``skip_reason``; a skipped cell returns before any mesh is built) and,
traced on the mesh:

* ``chips``;
* ``memory.argument_bytes``: this rank's local bytes of state (or
  parameters and cache) plus inputs, read from the placements (the rules
  shard evenly, so every rank holds as many); ``peak_bytes`` is null:
  the trace runs on ``meta`` tensors, which have no storage for a
  tracker (``torch.distributed._tools.mem_tracker.MemTracker`` counts
  storages) to see, and no ``FakeTensorMode`` trace is made;
* ``cost.flops``: per device, the FLOPs of the ops on this rank's local
  shards (``torch.utils.flop_counter``'s formulas; the DTensor-level call
  of each op and the shape propagation DTensor runs on fake tensors are
  not counted, so no op counts twice);
* ``collectives``: ``launch.hlo_stats.collective_bytes`` of the
  functional collectives the step issued;
* ``trace_s``: host seconds of the trace;
* ``status`` ``ok``, or ``FAILED`` with the error and its traceback.

These figures are abstract (meta tensors, fake ranks): no time on any
chip.  Dropped from the reference's flags, which only XLA knows:
``--fit`` (the two-point while-loop cost fit; nothing here is a loop
XLA would fold), ``scan_unroll`` (the port runs its layers in a Python
loop) and ``--cache-update`` (a lowering choice of the decode cache
write).

Run it in a process of its own: it starts the fake process group first,
as the reference sets ``XLA_FLAGS`` first.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --both-meshes
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import abstract_run
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCell, cell_skip, \
    get_config
from repro_torch.launch import steps as S
from repro_torch.launch.hlo_stats import (CollectiveRecorder,
                                          collective_bytes, dtensor_call)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import activation_sharding
from repro_torch.parallel.local import is_dtensor


class LocalFlops(TorchDispatchMode):
    """FLOPs of the ops run on plain (local) tensors: a DTensor call is
    passed on to DTensor, whose local ops come back here; the fake
    tensors of DTensor's shape propagation are skipped."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_call(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None and not any(
                isinstance(a, FakeTensor) for a in args):
            self.flops += fn(*args, **kwargs, out_val=out)
        return out


def local_bytes(*trees) -> int:
    """This rank's bytes of every tensor leaf of ``trees``: a DTensor's
    local shard, a plain tensor whole."""
    total = 0
    for tree in trees:
        for _, t in SH.named_leaves(tree):
            if isinstance(t, torch.Tensor):
                loc = t.to_local() if is_dtensor(t) else t
                total += loc.numel() * loc.element_size()
    return total


def apply_variants(cfg, args):
    changes = {}
    if args.moe_dispatch and cfg.moe is not None:
        changes["moe"] = dataclasses.replace(cfg.moe,
                                             dispatch=args.moe_dispatch)
    if args.remat:
        changes["remat"] = args.remat
    if args.attn_chunk:
        changes["attn_chunk"] = args.attn_chunk
    if args.logicnet_ffn:
        from repro_torch.models.config import LogicNetFFNCfg
        changes["logicnet_ffn"] = LogicNetFFNCfg(fan_in=64, bw=4,
                                                 max_val=4.0)
    return dataclasses.replace(cfg, **changes)


def mesh_free_record(cfg, arch: str, shape_name: str, mesh_name: str,
                     variant: str, cell: ShapeCell) -> dict:
    """The fields the config alone gives, before any mesh."""
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "variant": variant, "kind": cell.kind,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count(),
              "seq_len": cell.seq_len, "global_batch": cell.global_batch}
    skip = cell_skip(cfg, shape_name)
    if skip:
        record["status"] = "skipped"
        record["skip_reason"] = skip
    return record


def _serving_model(cfg, mesh, policy) -> M.LM:
    params = {n: p.detach() for n, p in S.abstract_params(cfg).items()}
    params = SH.distribute(params, mesh, policy)
    return M.LM(cfg, params)


def trace_step(cfg, cell: ShapeCell, mesh, policy, args) -> tuple:
    """Run the cell's step on ``mesh`` (meta tensors, under the activation
    rules): ``(argument bytes, flops, collective record)``."""
    specs = S.input_specs(cfg, cell)
    flops, coll = LocalFlops(), CollectiveRecorder()
    with abstract_run(), activation_sharding(
            mesh, SH.activation_rules(policy)):
        if cell.kind == "train":
            state = S.abstract_train_state(cfg)
            state_sh = SH.shardings_for_tree(state, mesh, policy)
            state = SH.distribute(state, mesh, policy)
            batch = SH.distribute_by_specs(
                specs["batch"], SH.batch_specs(policy, mesh,
                                               specs["batch"]), mesh)
            step = S.make_train_step(
                cfg, grad_shardings=S.grad_shardings(state_sh)
                if args.grad_rs else None)
            arg_bytes = local_bytes(state, batch)
            with flops, coll:
                step(state, batch)
        elif cell.kind == "prefill":
            model = _serving_model(cfg, mesh, policy)
            batch = SH.distribute_by_specs(
                specs["batch"], SH.batch_specs(policy, mesh,
                                               specs["batch"]), mesh)
            arg_bytes = local_bytes(model.params, batch)
            with torch.no_grad(), flops, coll:
                S.make_prefill_step(cfg)(model, batch)
        else:
            model = _serving_model(cfg, mesh, policy)
            cache = SH.distribute_by_specs(
                specs["cache"], SH.cache_specs(
                    policy, mesh, specs["cache"],
                    cache_shard=args.cache_shard), mesh)
            toks = {"tokens": specs["tokens"], "pos": specs["pos"]}
            toks = SH.distribute_by_specs(
                toks, SH.batch_specs(policy, mesh, toks), mesh)
            arg_bytes = local_bytes(model.params, cache, toks)
            with torch.no_grad(), flops, coll:
                S.make_decode_step(cfg)(model, cache, toks["tokens"],
                                        toks["pos"])
    return arg_bytes, flops.flops, coll.record


def trace_mesh(mesh, policy):
    """The ``(mesh, policy)`` a cell's step is traced on: ``mesh`` itself,
    but for the multi-pod mesh, whose ``pod`` and ``data`` axes the rules
    only ever use together (``("pod", "data")``, pod major): there the
    two are one 32-way ``data`` axis over the same 512 ranks, which is
    what that sharding is a device's view of (its all-gathers and
    reductions span the 32 ranks at once, as XLA's replica groups do).
    DTensor plans a redistribution of a tensor dimension sharded over two
    mesh dimensions by a shortest-path search for every op, which takes
    minutes a cell on the 3-D mesh."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh, policy
    from torch.distributed.device_mesh import init_device_mesh
    sizes = SH.axis_sizes(mesh)
    flat = init_device_mesh(
        "cpu", (sizes["pod"] * sizes["data"], sizes["model"]),
        mesh_dim_names=("data", "model"))
    return flat, SH.ShardingPolicy(fsdp=("data",), tp=policy.tp,
                                   mode=policy.mode)


def run_cell(arch: str, shape_name: str, multi_pod: bool, args) -> dict:
    cfg = apply_variants(get_config(arch), args)
    cell = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record = mesh_free_record(cfg, arch, shape_name, mesh_name,
                              args.variant, cell)
    if record.get("status") == "skipped":
        return record

    mesh = make_production_mesh(multi_pod=multi_pod)
    policy = (SH.multi_pod_policy(args.policy) if multi_pod
              else SH.ShardingPolicy(mode=args.policy))
    record["chips"] = mesh.size()
    record["pod_on_weights"] = any(
        "pod" in (a if isinstance(a, tuple) else (a,))
        for spec in SH.tree_specs(S.abstract_params(cfg), mesh,
                                  policy).values() for a in spec if a)
    t0 = time.perf_counter()
    arg_bytes, flops, coll = trace_step(cfg, cell,
                                        *trace_mesh(mesh, policy), args)
    record["trace_s"] = round(time.perf_counter() - t0, 1)
    record["memory"] = {"argument_bytes": arg_bytes, "peak_bytes": None}
    record["cost"] = {"flops": float(flops)}
    record["collectives"] = collective_bytes(coll)
    record["status"] = "ok"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} "
          f"({args.variant}): OK  flops={flops:.3e}  "
          f"coll={record['collectives']['total']:.3e}B  "
          f"trace={record['trace_s']}s", flush=True)
    print("  memory:", record["memory"], flush=True)
    return record


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Trace every (arch x shape x mesh) cell's step on the "
                    "production mesh (fake ranks, meta tensors).")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="fsdp_tp",
                    choices=["fsdp_tp", "tp_only"])
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "dense", "sorted", "sorted_local"])
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "dots", "full"])
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--cache-shard", default="heads",
                    choices=["heads", "seq"])
    ap.add_argument("--grad-rs", action="store_true",
                    help="redistribute grads to the param placements "
                         "(reduce-scatter instead of all-reduce)")
    ap.add_argument("--logicnet-ffn", action="store_true",
                    help="swap FFNs for the paper's sparse-quantized "
                         "LogicNet-FFN (the technique cell)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact is already ok")
    ap.add_argument("--out", default="experiments/dryrun")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                try:
                    rec = run_cell(arch, shape, mp, args)
                except Exception as e:  # a failure = a system bug
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "variant": args.variant,
                           "status": "FAILED", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
