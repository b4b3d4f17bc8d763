"""Batched LM serving: a continuous-batching decode loop.

The port's counterpart of ``examples/serve_lm.py``: a request queue, a
fixed-width decode batch with slot recycling (a finished request's slot is
refilled from the queue next step), per-slot KV caches and positions,
greedy sampling.  Prompts are fed one token per decode step, as in the
reference; its admission, stop rule and numpy prompt generator are kept.
The model's weights are the port's seeded init (``launch.steps.init_params``
at seed 0), or with ``--ckpt-dir`` those of the latest checkpoint that
``repro_torch.launch.train`` wrote there; no weights are downloaded.
``--logicnet-ffn`` serves the LogicNet-FFN variant (``LogicNetFFNCfg()``,
as ``launch.train --logicnet-ffn`` trains it): prefill through the flash
and masked-matmul kernels, every decode step's FFN products through the
masked-matmul kernel at M = slots.

Every decoder-only family of the zoo serves through the same loop: the
dense decoders, the mixture-of-experts ones (olmoe-1b-7b,
qwen3-moe-235b-a22b) and the SSM stacks (mamba2-370m, zamba2-2.7b, whose
decode state a recycled slot carries over from its previous request, as
the reference's loop does).  A full config whose float32 weights and
compute copy pass one card's memory (qwen3-moe-235b-a22b: 235 G
parameters) is refused.

    # the smoke config on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-1.7b \\
        --requests 12 --slots 4 --max-new 24 --device cpu

    # the full published config on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-1.7b \\
        --width full
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch olmoe-1b-7b \\
        --width full        # also mamba2-370m, zamba2-2.7b

    # a trained LogicNet-FFN model (launch.train --full --logicnet-ffn
    # --ckpt-dir DIR)
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --width full \\
        --logicnet-ffn --ckpt-dir DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.steps import (init_params, make_decode_step,
                                      restore_model)
from repro_torch.models import model as M
from repro_torch.models.config import LogicNetFFNCfg, ModelCfg

# one card's memory: an H100's 80 GB
CARD_BYTES = 80e9
# a served parameter's bytes: its float32 master and its compute copy
SERVED_BYTES_PER_PARAM = 4 + 2


@dataclasses.dataclass
class ServeResult:
    done: list          # finished requests: {"id", "prompt", "fed", "out"}
    steps: int          # decode steps taken
    seconds: float      # host clock over the loop, synchronised each step
    slots: int

    @property
    def tokens(self) -> int:
        return sum(len(r["out"]) for r in self.done)

    @property
    def occupancy(self) -> float:
        return self.tokens / max(self.steps * self.slots, 1)


def serve(cfg: ModelCfg, model: M.LM, requests: int = 12, slots: int = 4,
          max_new: int = 24, cache_len: int = 128) -> ServeResult:
    """Serve ``requests`` seeded prompts through ``slots`` decode slots.

    Each step decodes one token for every slot (idle slots included, as in
    the reference); a slot still feeding its prompt takes the prompt's next
    token, otherwise the greedy token is appended.  A request ends after
    ``max_new`` tokens or when its position reaches ``cache_len - 1``.
    """
    if cfg.enc_dec or cfg.vision_tokens:
        raise ValueError("the LM server supports decoder-only archs")
    dev = model.device
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(0)
    queue = [{"id": i,
              "prompt": rng.integers(1, cfg.vocab,
                                     rng.integers(4, 12)).tolist()}
             for i in range(requests)]
    done: list[dict] = []

    cache = M.init_cache(cfg, slots, cache_len, device=dev)
    # host mirrors of the positions and next tokens, uploaded every step
    pos = np.zeros((slots,), np.int32)
    cur_tok = np.zeros((slots, 1), np.int32)
    active: list[dict | None] = [None] * slots

    def admit():
        for s in range(slots):
            if active[s] is None and queue:
                req = queue.pop(0)
                active[s] = {"id": req["id"], "prompt": req["prompt"],
                             "fed": 1, "out": []}
                pos[s] = 0
                cur_tok[s, 0] = req["prompt"][0]

    admit()
    t0 = time.perf_counter()
    steps = 0
    while any(s is not None for s in active):
        logits, cache = decode(model, cache,
                               torch.from_numpy(cur_tok).to(dev),
                               torch.from_numpy(pos).to(dev))
        next_ids = logits.argmax(dim=-1).cpu().numpy()
        pos = pos + 1
        steps += 1
        for s in range(slots):
            req = active[s]
            if req is None:
                continue
            if req["fed"] < len(req["prompt"]):      # still prefilling
                cur_tok[s, 0] = req["prompt"][req["fed"]]
                req["fed"] += 1
                continue
            req["out"].append(int(next_ids[s]))
            cur_tok[s, 0] = int(next_ids[s])
            if len(req["out"]) >= max_new or int(pos[s]) >= cache_len - 1:
                done.append(req)
                active[s] = None                     # recycle the slot
        admit()
    return ServeResult(done, steps, time.perf_counter() - t0, slots)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--width", choices=("smoke", "full"), default="smoke",
                    help="the reference's smoke config or its full "
                         "published config")
    ap.add_argument("--logicnet-ffn", action="store_true",
                    help="the LogicNet-FFN variant (LogicNetFFNCfg())")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the parameters of the latest checkpoint "
                         "launch.train wrote here (same --arch, --width "
                         "and --logicnet-ffn)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.width == "smoke" else get_config)(
        args.arch)
    if cfg.enc_dec or cfg.vision_tokens:
        raise SystemExit("demo server supports decoder-only archs")
    n = cfg.param_count()
    if n * SERVED_BYTES_PER_PARAM > CARD_BYTES:
        raise SystemExit(
            f"{cfg.arch_id} has {n / 1e9:.0f} G parameters: their float32 "
            f"weights and {cfg.compute_dtype} copy "
            f"({n * SERVED_BYTES_PER_PARAM / 1e9:.0f} GB) do not fit one "
            f"card ({CARD_BYTES / 1e9:.0f} GB)")
    if args.logicnet_ffn:
        cfg = dataclasses.replace(cfg, logicnet_ffn=LogicNetFFNCfg())
    if args.ckpt_dir is None:
        model = init_params(cfg, seed=0, device=args.device)
    else:
        step, model = restore_model(cfg, args.ckpt_dir, args.device)
        print(f"parameters of step {step} from {args.ckpt_dir}")
    res = serve(cfg, model, requests=args.requests, slots=args.slots,
                max_new=args.max_new, cache_len=args.cache_len)
    print(f"served {len(res.done)} requests, {res.tokens} tokens in "
          f"{res.steps} decode steps ({res.seconds:.1f}s, "
          f"{1e3 * res.seconds / max(res.steps, 1):.0f} ms/step, "
          f"batch occupancy {res.occupancy:.2f})")
    for r in res.done[:3]:
        print(f"  req {r['id']}: prompt {len(r['prompt'])} toks -> "
              f"{r['out'][:8]}...")
    if len(res.done) != args.requests:
        raise SystemExit(f"served {len(res.done)} of {args.requests} "
                         f"requests")


if __name__ == "__main__":
    main()
