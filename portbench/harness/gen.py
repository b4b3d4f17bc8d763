"""Inputs made from ``--seed``: weights, fan-in masks, tokens, the order of
prompt lengths.  Everything is drawn on the run's device by generators
seeded from the run's seed, so the same seed gives the same inputs to the
program and to the reference."""

from __future__ import annotations

import hashlib
import math
import random
import statistics

import torch

from portbench.reference.model import fan_ins, param_specs

# elements drawn by one call of the weights' generator
DRAW_CHUNK = 1 << 30


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def fan_in_mask(gen: torch.Generator, n_in: int, n_out: int, k: int,
                device) -> torch.Tensor:
    """(n_in, n_out) float32 {0, 1}: each output column reads ``k``
    distinct inputs, drawn uniformly (the top ``k`` of uniform keys)."""
    keys = torch.rand((n_out, n_in), generator=gen, device=device)
    idx = keys.topk(k, dim=1).indices
    mask = torch.zeros((n_out, n_in), device=device).scatter_(1, idx, 1.0)
    return mask.t().contiguous()


def make_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of :func:`reference.model.param_specs`, float32 on
    ``device``: the normal leaves from a few large draws, one pair of
    fan-in masks copied into every layer."""
    specs = param_specs(cfg)
    gen = _generator(seed, "weights", device)
    out: dict[str, torch.Tensor] = {}
    groups: list[list] = [[]]
    drawn = 0
    for name, shape, init in specs:
        if init[0] == "normal":
            shape = torch.Size(shape)
            if groups[-1] and drawn + shape.numel() > DRAW_CHUNK:
                groups.append([])
                drawn = 0
            groups[-1].append((name, shape, init[1]))
            drawn += shape.numel()
    for group in groups:
        flat = torch.randn(sum(s.numel() for _, s, _ in group),
                           generator=gen, device=device)
        off = 0
        for name, shape, std in group:
            out[name] = flat[off:off + shape.numel()].view(shape) * std
            off += shape.numel()
        del flat
    masks = {}
    if cfg.get("logicnet_ffn"):
        mgen = _generator(seed, "masks", device)
        k_in, k_out = fan_ins(cfg)
        d, dff = cfg["d_model"], cfg["d_ff"]
        masks = {"mask_in": fan_in_mask(mgen, d, dff, k_in, device),
                 "mask_out": fan_in_mask(mgen, dff, d, k_out, device)}
    for name, shape, init in specs:
        kind = init[0]
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "a_log":
            out[name] = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                                 device=device))
        elif kind in masks:
            out[name] = masks[kind].clone()
    return {name: out[name] for name, _, _ in specs}


class TrainBatches:
    """Training batches, each ``batch`` rows of ``seq_len + 1`` ids
    uniform over the vocabulary: tokens the first ``seq_len``, labels the
    next token.  ``next()`` draws the run's next batch, ``first(n)`` its
    first ``n`` again."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 device):
        self.shape = (batch, seq_len + 1)
        self.vocab, self.device, self.seed = vocab, device, seed
        self._gen = _generator(seed, "tokens", device)

    def next(self) -> dict:
        ids = torch.randint(0, self.vocab, self.shape, generator=self._gen,
                            device=self.device)
        return {"tokens": ids[:, :-1].to(torch.int32).contiguous(),
                "labels": ids[:, 1:].to(torch.int32).contiguous()}

    def first(self, n: int) -> list[dict]:
        """The run's first ``n`` batches, drawn again."""
        again = TrainBatches(self.seed, self.shape[0], self.shape[1] - 1,
                             self.vocab, self.device)
        return [again.next() for _ in range(n)]


def length_block(spec: dict) -> list[int]:
    """The prompt lengths of one block of calls: the ``block`` quantiles
    (i + 0.5) / block of a log-normal of median ``median`` and shape
    ``sigma``, each rounded up to a multiple of ``multiple`` and held
    within ``min`` and ``max``.  Every seed gives the same block."""
    n, step = int(spec["block"]), int(spec["multiple"])
    z = statistics.NormalDist()
    out = []
    for i in range(n):
        raw = spec["median"] * math.exp(spec["sigma"]
                                        * z.inv_cdf((i + 0.5) / n))
        out.append(min(int(spec["max"]),
                       max(int(spec["min"]), step * math.ceil(raw / step))))
    return out


def prompt_lengths(seed: int, block: list[int]):
    """The prompt length of each call, endlessly: every ``len(block)``
    calls hold the block's lengths once each, in an order drawn from the
    seed, so every seed gives the same mix."""
    rng = random.Random(subseed(seed, "order"))
    while True:
        order = list(block)
        rng.shuffle(order)
        yield from order


class Prompts:
    """Prompt batches: ``tokens_per_call // length`` rows of ``length``
    ids uniform over the vocabulary, drawn in order from the seed's
    ``tag`` stream."""

    def __init__(self, seed: int, tag: str, tokens_per_call: int,
                 vocab: int, device):
        self.tokens, self.vocab, self.device = tokens_per_call, vocab, device
        self._gen = _generator(seed, tag, device)

    def next(self, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.tokens // length, length),
                             generator=self._gen, device=self.device,
                             dtype=torch.int32)
