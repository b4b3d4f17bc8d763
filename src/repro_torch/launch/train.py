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

The reference's ``--model-parallel`` and ``--grad-rs`` shard over a JAX
mesh (ROADMAP item 10); they are not ported, and one process trains on
one device.
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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import steps as S
from repro_torch.models.config import LogicNetFFNCfg, ModelCfg
from repro_torch.optim.adamw import AdamWCfg, cosine_schedule
from repro_torch.runtime import TrainLoop, TrainLoopCfg


def size_100m(cfg: ModelCfg) -> ModelCfg:
    """~100M-param variant of the family (``examples/train_lm.py``)."""
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=8192, attn_chunk=256, remat="none")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Train an LM of the zoo on one device.",
        epilog="Not ported: --model-parallel and --grad-rs (they shard "
               "over a JAX mesh, ROADMAP item 10).")
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


def build(args: argparse.Namespace, cfg: ModelCfg | None = None) -> Run:
    """The config (``cfg``, else the flags' :func:`config`), a state from
    seed 0 on the device, the train step (its host time recorded, the
    device synchronised), the data stream and the loop; restored from
    ``--ckpt-dir`` with ``--resume``."""
    cfg = cfg or config(args)
    dev = resolve_device(args.device)
    opt = AdamWCfg(lr=args.lr, weight_decay=0.01,
                   schedule=cosine_schedule(warmup=min(20, args.steps // 5),
                                            total=args.steps))
    # a run that resumes restores onto a state described on the meta
    # device, so the device never holds two states at once
    resume = args.resume and latest_step(args.ckpt_dir) is not None
    state = (S.abstract_train_state(cfg) if resume
             else S.make_train_state(cfg, seed=0, device=dev))
    raw_step = S.make_train_step(cfg, opt)
    step_s: list[float] = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        out = raw_step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        return out

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.global_batch, seed=0)

    def batches(i: int) -> dict:
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in stream.batch(i).items()}
        # the stub frontends' inputs are zeros, as in the reference
        n = out["tokens"].shape[0]
        if cfg.vision_tokens > 0:
            out["vision_embeds"] = torch.zeros(
                (n, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        if cfg.enc_dec:
            out["frames"] = torch.zeros((n, cfg.enc_frames, cfg.d_model),
                                        dtype=torch.bfloat16, device=dev)
        return out

    loop = TrainLoop(TrainLoopCfg(ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every,
                                  async_save=True), step_fn, state)
    if resume:
        loop.try_restore(device=dev)
    return Run(cfg, dev, loop, batches, step_s)


def summary(run: Run) -> str:
    """The reference's ``[train]`` line, then ms a step (after the first
    two, where there are more) and the device's name."""
    m = run.loop.metrics
    timed = run.step_s[2:] or run.step_s
    name = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu")
    return (f"[train] {run.cfg.arch_id}: loss {m[0][1]:.3f} -> "
            f"{m[-1][1]:.3f} over {len(m)} steps, "
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
