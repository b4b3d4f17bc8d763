"""Step spans (``repro_torch.obs.trace.span``) in the LM train and prefill
steps, on the CPU.

While spans are off, ``span`` returns one shared no-op and a profiler
records no program annotation.  With spans on, a profiler that records
CPU activity sees the named tree (``train_step`` over ``forward``,
``backward``, ``nan_guard`` and ``adamw``; ``attn`` and ``ffn`` once a
layer in the forward and again in remat's recompute), and the steps'
numbers are bit for bit those with spans off.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from torch_port_util import one_torch_thread  # noqa: F401

from repro_torch import configs as PC
from repro_torch.data import TokenStream
from repro_torch.launch import steps
from repro_torch.models.config import LogicNetFFNCfg
from repro_torch.obs import trace
from repro_torch.optim import AdamWCfg

SEQ, BATCH = 32, 2
ADAMW = AdamWCfg(lr=3e-4, weight_decay=0.01)


def _cfg(**kw):
    kw = {"compute_dtype": "bfloat16", "remat": "full", **kw}
    return dataclasses.replace(PC.get_smoke_config("qwen3-1.7b"),
                               logicnet_ffn=LogicNetFFNCfg(), **kw)


def _batches(cfg, n):
    stream = TokenStream(cfg.vocab, SEQ, BATCH, seed=0)
    return [{k: torch.as_tensor(v) for k, v in stream.batch(i).items()}
            for i in range(n)]


def _train(cfg, batches, on: bool):
    """Losses and the final state of steps over ``batches``, spans on or
    off."""
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    step = steps.make_train_step(cfg, ADAMW)
    losses = []
    with trace.spans_enabled() if on else contextlib.nullcontext():
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss)
    return losses, state


def _annotations(prof):
    """``[(name, thread, start, end)]`` of the program's annotations."""
    return sorted(((e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda a: a[2])


def _children(spans, parent):
    """The spans directly under ``parent`` on its thread, in order."""
    _, thread, a, b = parent
    inside = [s for s in spans if s is not parent and s[1] == thread
              and a <= s[2] and s[3] <= b]
    return [s for s in inside
            if not any(o is not s and o[2] <= s[2] and s[3] <= o[3]
                       for o in inside)]


def test_span_off_is_one_shared_noop():
    assert trace.span("forward") is trace.span("adamw")
    with trace.span("forward") as got:
        assert got is None


def test_spans_enabled_turns_on_and_restores():
    with trace.spans_enabled():
        assert isinstance(trace.span("forward"), record_function)
        with trace.spans_enabled():
            pass
        assert isinstance(trace.span("forward"), record_function)
    assert trace.span("forward") is trace.span("adamw")


def test_spans_off_record_no_annotation():
    cfg = _cfg(n_layers=1)
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    step = steps.make_train_step(cfg, ADAMW)
    model = steps.model_from_state(cfg, state)
    batch = _batches(cfg, 1)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
        steps.make_prefill_step(cfg)(model, {"tokens": batch["tokens"]})
    assert _annotations(prof) == []


def test_train_step_bits_equal_with_spans_on():
    cfg = _cfg()
    batches = _batches(cfg, 2)
    off_losses, off = _train(cfg, batches, on=False)
    on_losses, on = _train(cfg, batches, on=True)
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for name, p in off["params"].items():
        assert torch.equal(p, on["params"][name]), name
        assert torch.equal(off["opt"]["m"][name], on["opt"]["m"][name]), name
        assert torch.equal(off["opt"]["v"][name], on["opt"]["v"][name]), name
    assert torch.equal(off["opt"]["step"], on["opt"]["step"])


def test_prefill_bits_equal_with_spans_on():
    cfg = _cfg()
    model = steps.model_from_state(
        cfg, steps.make_train_state(cfg, seed=0, device="cpu"))
    prefill = steps.make_prefill_step(cfg)
    tokens = {"tokens": _batches(cfg, 1)[0]["tokens"]}
    off = prefill(model, tokens)
    with trace.spans_enabled():
        on = prefill(model, tokens)
    assert torch.equal(off, on)


def test_train_step_span_tree():
    cfg = _cfg()
    batch = _batches(cfg, 1)[0]
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    step = steps.make_train_step(cfg, ADAMW)
    with trace.spans_enabled(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = _annotations(prof)
    tops = [s for s in spans if s[0] == "train_step"]
    assert len(tops) == 1
    parts = _children(spans, tops[0])
    assert [s[0] for s in parts] == ["forward", "backward", "nan_guard",
                                     "adamw"]
    forward, backward = parts[0], parts[1]
    n = cfg.n_layers
    assert [s[0] for s in _children(spans, forward)] == (
        ["attn", "ffn"] * n + ["head", "loss"])
    # remat recomputes each layer inside the backward pass; on a CPU
    # graph autograd runs on the stepping thread, so the recomputed spans
    # nest under ``backward``
    assert [s[0] for s in _children(spans, backward)] == ["attn", "ffn"] * n


def test_train_step_spans_without_remat():
    cfg = _cfg(remat="none", n_layers=1)
    batch = _batches(cfg, 1)[0]
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    with trace.spans_enabled(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.make_train_step(cfg, ADAMW)(state, batch)
    spans = _annotations(prof)
    backward = next(s for s in spans if s[0] == "backward")
    assert _children(spans, backward) == []
    assert sum(s[0] == "attn" for s in spans) == 1


@pytest.mark.parametrize("layers", [1, 2])
def test_prefill_span_tree(layers):
    cfg = _cfg(n_layers=layers)
    model = steps.model_from_state(
        cfg, steps.make_train_state(cfg, seed=0, device="cpu"))
    tokens = {"tokens": _batches(cfg, 1)[0]["tokens"]}
    with trace.spans_enabled(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.make_prefill_step(cfg)(model, tokens)
    spans = _annotations(prof)
    tops = [s for s in spans if s[0] == "prefill_step"]
    assert len(tops) == 1
    assert [s[0] for s in _children(spans, tops[0])] == (
        ["attn", "ffn"] * layers + ["head"])


def test_meta_train_step_with_spans_on():
    """The dry-run's abstract step (``meta`` tensors) runs with spans on
    as with them off."""
    from repro_torch._device import abstract_run
    cfg = _cfg(n_layers=1)
    state = steps.abstract_train_state(cfg)
    batch = {k: torch.zeros((BATCH, SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    with abstract_run(), trace.spans_enabled():
        _, loss = steps.make_train_step(cfg, ADAMW)(state, batch)
    assert loss.device.type == "meta" and loss.shape == ()
