"""Zamba2's own layout (Zamba2-7B-Instruct) in the port against the
benchmark's plain reference (``portbench/reference/zamba2.py``), on the
CPU at float32.

A smoke config with two groups, both shared blocks (sites A B A) and a
rank-4 LoRA, on weights the benchmark's generator draws from a seed: the
loss, the gradient of every leaf and the prefill step's last logits equal
the reference's to a relative 1e-5.  Each planted variant of the
reference (the site's output added into the residual, one block at every
site, no LoRA, tanh GELU, an ungrouped gated norm, the scale 1/sqrt(224))
fails that comparison.  The published config's parameters are the
reference's, 7.357 G uncut and 2.733 G at the benchmark's cut; the train
step opens ``ssm/ssd``, ``attn`` and ``ffn`` spans, and the shared blocks
run in turn.
"""

import dataclasses
import json
import math
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from torch_port_util import one_torch_thread  # noqa: F401

from portbench.harness import check, gen, port, runner, spans, spec, train
from portbench.reference import zamba2 as R
from portbench.reference.precision import exact_matmuls
from repro_torch.configs import zamba2_7b
from repro_torch.launch import steps
from repro_torch.models import config
from repro_torch.models import model as M
from repro_torch.obs import trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "zamba2-7b.train.4x2048"
SEED, BATCH, SEQ = 7, 2, 16
# float32 on both sides: the program's chunked attention and SSD sum in
# another order than the reference's, a few float32 roundings apart
TOL = 1e-5


def _cfg(**kw) -> dict:
    """The smoke config as the reference reads it (a configuration file's
    keys), in float32."""
    cfg = dataclasses.asdict(zamba2_7b.smoke_config())
    return dict(cfg, compute_dtype="float32", **kw)


def _tokens():
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, _cfg()["vocab"], (BATCH, SEQ + 1), generator=g,
                        dtype=torch.int32)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def _program(cfg: dict):
    """The port's loss, every leaf's gradient and the prefill step's last
    logits on the seed's weights."""
    mcfg = port.model_cfg(cfg)
    params = {n: p.requires_grad_() for n, p in port.fill(
        mcfg, gen.make_params(R, cfg, SEED, "cpu")).items()}
    tokens, labels = _tokens()
    loss = M.loss_fn(params, mcfg, {"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, list(params.values()))
    model = steps.model_from_state(mcfg, {"params": params})
    logits = steps.make_prefill_step(mcfg)(model, {"tokens": tokens})
    return (loss.detach(), dict(zip(params, grads)), logits.detach())


def _reference(cfg: dict):
    params = gen.make_params(R, cfg, SEED, "cpu")
    for p in params.values():
        p.requires_grad_()
    tokens, labels = _tokens()
    with exact_matmuls():
        loss = R.loss(params, cfg, tokens, labels)
        # a variant may leave a leaf out: its gradient is then zero
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        logits = R.last_logits(params, cfg, tokens)
    return loss.detach(), dict(zip(params, grads)), logits


def _gaps(prog, ref) -> dict:
    """Relative gaps: the loss's, the worst leaf's gradient (against that
    leaf's norm or the median leaf's, whichever is larger) and the last
    logits'."""
    norms = {n: g.norm().item() for n, g in ref[1].items()}
    med = sorted(norms.values())[len(norms) // 2]
    grad = max((prog[1][n] - g).norm().item() / max(norms[n], med)
               for n, g in ref[1].items())
    return {"loss": abs(prog[0] - ref[0]).item() / abs(ref[0]).item(),
            "grad": grad,
            "logits": ((prog[2] - ref[2]).abs().max()
                       / ref[2].abs().max()).item()}


@pytest.fixture(scope="module")
def program():
    return _program(_cfg())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_and_logits_match_the_reference(remat):
    cfg = _cfg(remat=remat)
    gaps = _gaps(_program(cfg), _reference(cfg))
    assert max(gaps.values()) <= TOL, gaps


def _one_block(site, cfg):
    return 0


VARIANTS = {
    "t_in_residual": ("ssm_block", lambda real: (
        lambda p, h, t, cfg, prec: real(p, h if t is None else h + t, None,
                                        cfg, prec))),
    "one_block": ("block_of", lambda real: _one_block),
    "no_lora": ("lora", lambda real: (
        lambda site, y, prec: 0.0 * real(site, y, prec))),
    "tanh_gelu": ("gelu", lambda real: (
        lambda x: F.gelu(x, approximate="tanh"))),
    "ungrouped_norm": ("gated_norm", lambda real: (
        lambda y, scale, groups, eps: real(y, scale, 1, eps))),
    "scale_rsqrt_head_dim": ("attn_scale", lambda real: (
        lambda cfg: cfg["head_dim"] ** -0.5)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_each_planted_variant_fails_the_comparison(variant, program,
                                                   monkeypatch):
    name, make = VARIANTS[variant]
    monkeypatch.setattr(R, name, make(getattr(R, name)))
    gaps = _gaps(program, _reference(_cfg()))
    assert max(gaps.values()) > 10 * TOL, gaps


def test_published_parameters_are_the_references():
    full = zamba2_7b.config()
    cut = dataclasses.replace(full, n_layers=24,
                              hybrid_layer_ids=(6, 11, 17, 23))
    for cfg, count in ((full, 7_356_749_648), (cut, 2_733_050_240)):
        ours = M.param_shapes(cfg)
        ref = {n: tuple(s) for n, s, _ in
               R.param_specs(dataclasses.asdict(cfg))}
        assert ours == ref
        assert sum(math.prod(s) for s in ours.values()) == count
        assert {t.device.type for t in
                steps.abstract_params(cfg).values()} == {"meta"}
    # the benchmark's configuration file is the cut, as it is run, and
    # carries its source's config, the cut keys' published values apart
    file = _config_file()
    run = port.model_cfg(spec.run_keys(file))
    assert _without_source_keys(run) == cut
    assert (run.hidden_size, run.attention_head_dim, run.mamba_ngroups,
            run.num_hidden_layers) == (3584, 224, 2, 24)
    published = file["published"]
    uncut = port.model_cfg(dict(
        spec.run_keys(file), n_layers=81,
        **{k: published[k] for k in ("num_hidden_layers",
                                     "hybrid_layer_ids",
                                     "layers_block_type")}))
    assert _without_source_keys(uncut) == full


def _config_file() -> dict:
    return json.loads((ROOT / "portbench" / "configs"
                       / "zamba2-7b.json").read_text())


def _without_source_keys(cfg):
    return dataclasses.replace(
        cfg, **{k: None for k in config.ZAMBA2_SOURCE_KEYS})


@pytest.mark.parametrize("key, value", [
    ("attention_head_dim", 112), ("num_hidden_layers", 81),
    ("mamba_ngroups", 1), ("hidden_act", "gelu_pytorch_tanh"),
    ("use_shared_attention_adapter", True), ("time_step_limit", [0.0, 1.0]),
    ("layers_block_type", ["mamba"] * 24)])
def test_a_source_key_that_differs_from_the_run_is_refused(key, value):
    run = spec.run_keys(_config_file())
    port.model_cfg(run)
    with pytest.raises(ValueError, match=key):
        port.model_cfg(dict(run, **{key: value}))


def _annotations(prof):
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _inside(inner, outer) -> bool:
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3] and inner is not outer)


class _Order(dict):
    """A counter that also keeps the order of its increments."""

    def __init__(self):
        super().__init__()
        self.order = []

    def __missing__(self, key):
        return 0

    def __setitem__(self, key, value):
        self.order.append(key)
        super().__setitem__(key, value)


def test_train_step_spans_and_the_blocks_in_turn(monkeypatch):
    cfg = port.model_cfg(dict(_cfg(), compute_dtype="bfloat16"))
    state = port.train_state(cfg, gen.make_params(R, _cfg(), SEED, "cpu"))
    step = steps.make_train_step(cfg)
    tokens, labels = _tokens()
    calls = _Order()
    monkeypatch.setattr(M.shared_block, "calls", calls)
    with trace.spans_enabled(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        _, loss = step(state, {"tokens": tokens, "labels": labels})
    assert math.isfinite(float(loss))
    assert calls.order == ["A", "B", "A"]
    assert dict(calls) == {"A": 2, "B": 1}
    found = _annotations(prof)
    named = {n: [a for a in found if a[0] == n]
             for n in ("ssm", "ssd", "attn", "ffn")}
    assert len(named["ssm"]) >= cfg.n_layers
    assert len(named["attn"]) >= 3 and len(named["ffn"]) >= 3
    assert named["ssd"] and all(any(_inside(s, o) for o in named["ssm"])
                                for s in named["ssd"])
    # the prefill step runs them in turn too
    calls.order.clear()
    model = steps.model_from_state(cfg, state)
    steps.make_prefill_step(cfg)(model, {"tokens": tokens})
    assert calls.order == ["A", "B", "A"]


def test_decode_raises_for_the_layout():
    cfg = zamba2_7b.smoke_config()
    with pytest.raises(NotImplementedError, match="hybrid_layer_ids"):
        M.cache_specs(cfg, 1, 8)
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="decode"):
        M.decode_step(model, {}, torch.zeros((1, 1), dtype=torch.int32),
                      torch.zeros((1,), dtype=torch.int32))


def test_a_bad_layout_is_refused():
    base = dataclasses.asdict(zamba2_7b.smoke_config())
    for bad in ({"hybrid_layer_ids": (3, 1)}, {"num_mem_blocks": 0},
                {"hybrid_layer_ids": (6,)}, {"hybrid_attn_every": 2}):
        with pytest.raises(ValueError, match="hybrid_layer_ids"):
            port.model_cfg(dict(base, **bad))


def test_the_cell_loads_and_its_readers_read_the_spans():
    cells = {c.name: c for c in spec.cells(ROOT)}
    cell = cells[CELL]
    assert cell.reference.__file__.endswith("zamba2.py")
    assert cell.kind == "train"
    names = [e["name"] for e in cell.per_layer]
    assert {"ssm_ms.train", "ssd_ms.train", "step_mfu.train",
            "attn_ms.train", "adamw_ms.train"} <= set(names)
    assert "masked_matmul_roofline.train" not in names
    unit = {"key": 0, "device_s": 0.05, "spans": 2,
            "by_path": {"train_step/forward/ssm/ssd": [0.01, 3],
                        "train_step/forward/ssm": [0.004, 2],
                        "train_step/backward/ssm/ssd": [0.02, 4],
                        "train_step/adamw": [0.016, 5]},
            "by_kind": {}}
    seg = spans.SpanTrace(units=[unit], busy_s=0.05, window_s=0.06,
                          gaps={}, tries=1)
    run = runner.Run(cell=cell, window={}, trace=None, peak_bytes=0,
                     spans=seg)
    assert cell.reader("ssm_ms.train")(run) == pytest.approx(34.0)
    assert cell.reader("ssd_ms.train")(run) == pytest.approx(30.0)
    # no segment, or a program without the spans: nothing to read
    bare = dict(unit, by_path={"train_step/adamw": [0.016, 5]})
    for spans_of in (None, dataclasses.replace(seg, units=[bare])):
        run = runner.Run(cell=cell, window={}, trace=None, peak_bytes=0,
                         spans=spans_of)
        assert cell.reader("ssm_ms.train")(run) is None
        assert cell.reader("ssd_ms.train")(run) is None


def test_the_harness_training_check_at_smoke_size():
    """The cell's own set-up and check, its traffic cut to two rows of 16
    tokens and its config to the smoke one, in float32: the program's
    readings hold the reference's."""
    cell = spec.cell(ROOT, CELL)
    cell.config = _cfg(remat="full")
    cell.traffic = dict(cell.traffic, batch=BATCH, seq_len=SEQ)
    t0 = time.perf_counter()
    _, _, batches, prog = train.setup(cell, 11, "cpu")
    ref = train.reference(cell, 11, batches, "cpu")
    nums = check.train_numbers(prog, ref)
    assert nums["loss_gap"] < TOL
    assert nums["grad_gap"] < 1e-4
    # AdamW's eps-conditioned elements of the SSM's small leaves
    assert nums["change_gap"] < 1e-3
    assert time.perf_counter() - t0 < 120
