"""LM training launcher: ``python -m repro_torch.launch.train``.

The port of ``repro.launch.train`` (and of ``examples/train_lm.py``'s
``--size``): config -> model -> AdamW (lr 3e-4, weight decay 0.01, a
cosine schedule) -> ``TokenStream`` batches -> the fault-tolerant
``TrainLoop`` (async checkpoints, NaN guard, ``--resume``).  Smoke config
by default; ``--full`` is the architecture's published config.
``--logicnet-ffn`` puts the paper's fan-in masks and activation
quantizers (``LogicNetFFNCfg()``: fan-in 16, 4 bits, max 4.0) in every
FFN, whose products then run the masked-matmul kernel on the card.

    # on the CPU: the smoke config (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --size smoke \\
        --device cpu --steps 20 --logicnet-ffn

    # on the card: qwen3-1.7b at its full published width
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --logicnet-ffn --steps 10

    # the other families: zamba2's shared block with the LogicNet-FFN
    # (also mamba2-370m and whisper-medium --seq 448; olmoe-1b-7b fits
    # one card only with its depth cut)
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --arch zamba2-2.7b --logicnet-ffn --steps 10

qwen2-vl-2b's batches carry zero vision embeddings, as the reference's
launcher makes them; at its full 28 layers their rows' gradient
overflows in both packages (a zero row's ``rms_norm`` Jacobian is
1 / sqrt(eps)), so the first step writes NaN into the parameters.

``--model-parallel N`` or ``--grad-rs``, or a start under ``torchrun``,
puts the run on a ``(world // N, N)`` mesh ``("data", "model")`` over the
ranks (``launch.mesh.make_host_mesh``: ``nccl`` on the cards, ``gloo``
with ``--device cpu``; a lone process is a one-rank group): the state is
laid out by the sharding rules (``parallel.sharding``: FSDP over
``data``, tensor parallelism over ``model``), each rank reads its share of
the batch, and ``--grad-rs`` redistributes each gradient to its
parameter's placements before AdamW (the reduce-scatter).  Without them,
in one process, the run is the single-device path, unchanged.

    # one card, a (1, 1) mesh: the mesh path's bits equal the plain path's
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --logicnet-ffn --model-parallel 1 --grad-rs --steps 10

    # several cards of one host (4 ranks, model-parallel groups of 2)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --full --logicnet-ffn --model-parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint.ckpt import path_keys
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (describe, make_host_mesh, mesh_device,
                                     under_torchrun)
from repro_torch.models.config import LogicNetFFNCfg, ModelCfg
from repro_torch.optim.adamw import AdamWCfg, cosine_schedule
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import activation_sharding
from repro_torch.runtime import TrainLoop, TrainLoopCfg


def size_100m(cfg: ModelCfg) -> ModelCfg:
    """~100M-param variant of the family (``examples/train_lm.py``)."""
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=8192, attn_chunk=256, remat="none")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Train an LM of the zoo on one device, or on a mesh "
                    "of ranks.")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full published config")
    ap.add_argument("--size", default="smoke", choices=["smoke", "100m"],
                    help="without --full: the smoke config or its ~100M "
                         "variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256,
                    help="sequence length; keep it at most the config's "
                         "attn_chunk or a multiple of it (the chunked "
                         "attention mislabels a ragged last chunk, as the "
                         "reference's does)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--logicnet-ffn", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="train on a (world // N, N) mesh (data, model); "
                         "given, or --grad-rs, or under torchrun, the run "
                         "is on a mesh (N 1 when only the others ask)")
    ap.add_argument("--grad-rs", action="store_true",
                    help="redistribute gradients to the parameters' "
                         "placements before AdamW (reduce-scatter "
                         "instead of all-reduce)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def config(args: argparse.Namespace) -> ModelCfg:
    if args.full:
        cfg = get_config(args.arch)
    else:
        cfg = get_smoke_config(args.arch)
        if args.size == "100m":
            cfg = size_100m(cfg)
    if args.logicnet_ffn:
        cfg = dataclasses.replace(cfg, logicnet_ffn=LogicNetFFNCfg())
    return cfg


@dataclasses.dataclass
class Run:
    """A built training run: ``loop.run(batches, steps)`` trains it."""
    cfg: ModelCfg
    device: torch.device
    loop: TrainLoop
    batches: object
    step_s: list        # host seconds of each step, synchronised
    mesh: object = None  # the DeviceMesh of a mesh run


def token_batches(cfg: ModelCfg, seq: int, global_batch: int, dev,
                  mesh=None):
    """``batches(step)``: ``TokenStream(seed=0)``'s batch of that step on
    ``dev``, with the stub frontends' inputs, zero bfloat16
    ``vision_embeds`` / ``frames``, where the model reads them, as the
    reference's launcher feeds them.  On a mesh each data-parallel rank
    reads its host's share (``n_hosts`` the data axis, ``host`` its
    coordinate, as the reference's from ``jax.process_count()`` /
    ``process_index()``), and the batch is that share of DTensors
    sharded over ``data``."""
    n_hosts, host = 1, 0
    if mesh is not None:
        n_hosts, host = mesh.size(0), mesh.get_local_rank(mesh_dim=0)
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq,
                         global_batch=global_batch, seed=0,
                         n_hosts=n_hosts, host=host)

    def batches(i: int) -> dict:
        out = _local_batch(cfg, stream, i, dev)
        if mesh is None:
            return out
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(0)] + [Replicate()] * (mesh.ndim - 1)
        return {k: DTensor.from_local(v, mesh, pl, run_check=False)
                for k, v in out.items()}

    return batches


def _local_batch(cfg: ModelCfg, stream: TokenStream, i: int, dev) -> dict:
    """This host's share of the batch of step ``i`` on ``dev``."""
    out = {k: torch.from_numpy(v).to(dev)
           for k, v in stream.batch(i).items()}
    n = out["tokens"].shape[0]
    if cfg.vision_tokens > 0:
        out["vision_embeds"] = torch.zeros(
            (n, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.enc_dec:
        out["frames"] = torch.zeros((n, cfg.enc_frames, cfg.d_model),
                                    dtype=torch.bfloat16, device=dev)
    return out


def build(args: argparse.Namespace, cfg: ModelCfg | None = None) -> Run:
    """The config (``cfg``, else the flags' :func:`config`), a state from
    seed 0 on the device, the train step (its host time recorded, the
    device synchronised), the data stream and the loop; restored from
    ``--ckpt-dir`` with ``--resume``.

    On a mesh (:func:`on_mesh`) the state is drawn whole on each rank's
    device, from the same seed, and each rank keeps its shards
    (``parallel.sharding.distribute``); the step runs under the
    activation rules; ``--resume`` lays each restored leaf out by its
    rule (``try_restore(map_fn=)``)."""
    cfg = cfg or config(args)
    mesh = policy = None
    if on_mesh(args):
        mesh = make_host_mesh(args.model_parallel or 1, device=args.device)
        policy = SH.ShardingPolicy()
        dev = mesh_device(mesh)
    else:
        dev = resolve_device(args.device)
    opt = AdamWCfg(lr=args.lr, weight_decay=0.01,
                   schedule=cosine_schedule(warmup=min(20, args.steps // 5),
                                            total=args.steps))
    # a run that resumes restores onto a state described on the meta
    # device, so the device never holds two states at once
    resume = args.resume and latest_step(args.ckpt_dir) is not None
    state = (S.abstract_train_state(cfg) if resume
             else S.make_train_state(cfg, seed=0, device=dev))
    grad_sh = None
    if mesh is not None:
        state_sh = SH.shardings_for_tree(state, mesh, policy)
        if not resume:
            state = SH.distribute(state, mesh, policy)
        if args.grad_rs:
            grad_sh = S.grad_shardings(state_sh)
    raw_step = S.make_train_step(cfg, opt, grad_shardings=grad_sh)
    step_s: list[float] = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        if mesh is None:
            out = raw_step(state, batch)
        else:
            with activation_sharding(mesh, SH.activation_rules(policy)):
                out = raw_step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        return out

    batches = token_batches(cfg, args.seq, args.global_batch, dev, mesh)
    loop = TrainLoop(TrainLoopCfg(ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every,
                                  async_save=True), step_fn, state)
    if resume and mesh is not None:
        def map_fn(path, arr):
            name = ".".join(path_keys(path))
            pl = state_sh.get(name.removeprefix("state."))
            if pl is None:
                return None
            t = torch.from_numpy(arr).to(dev)
            return SH.distribute_leaf(
                t.requires_grad_(name.startswith("state.params.")),
                mesh, pl)
        loop.try_restore(device=dev, map_fn=map_fn)
    elif resume:
        loop.try_restore(device=dev)
    return Run(cfg, dev, loop, batches, step_s, mesh)


def on_mesh(args: argparse.Namespace) -> bool:
    """Whether the run is on a mesh: ``--model-parallel`` or
    ``--grad-rs`` given, or the process started by ``torchrun``."""
    return (args.model_parallel is not None or args.grad_rs
            or under_torchrun())


def summary(run: Run) -> str:
    """The reference's ``[train]`` line, then ms a step (after the first
    two, where there are more) and the device's name."""
    m = run.loop.metrics
    timed = run.step_s[2:] or run.step_s
    name = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu")
    where = "" if run.mesh is None else (
        f" on mesh {describe(run.mesh)} ({run.mesh.size()} ranks)")
    return (f"[train] {run.cfg.arch_id}: loss {m[0][1]:.3f} -> "
            f"{m[-1][1]:.3f} over {len(m)} steps{where}, "
            f"{1e3 * sum(timed) / max(len(timed), 1):.1f} ms a step "
            f"({name})")


def main(argv=None) -> None:
    args = parse_args(argv)
    run = build(args)
    run.loop.run(run.batches, args.steps)
    if not run.loop.metrics:
        raise SystemExit(f"no step ran: the loop was already at step "
                         f"{run.loop.step} of {args.steps}")
    print(summary(run))


if __name__ == "__main__":
    main()
