"""A whole run of each kind of cell on the CPU at smoke size, the chip's
look skipped: sound, it comes out correct; with the timed path broken
underneath (the program patched where the fault would lie), ``correct``
comes out false.  Faults a one-chip cell can have: a step that returns its
state unchanged; half of the batch left out, the mean taken over the rest;
an answer altered where it is produced (the step's loss, a served
token)."""

import time

import pytest
import torch

from portbench.harness import runner
from portbench.tests import smoke


def run(config, kind):
    return runner.run(smoke.cell(config, kind), 5, 0.0, False, "cpu",
                      time.perf_counter())


def half_rows(batch):
    return {k: v[:v.shape[0] // 2] for k, v in batch.items()}


def train_fault(monkeypatch, fault):
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    real = M.loss_fn
    if fault == "state_unchanged":
        monkeypatch.setattr(steps, "adamw_update", lambda *a, **k: None)
    elif fault == "half_batch":
        monkeypatch.setattr(M, "loss_fn", lambda params, cfg, batch: real(
            params, cfg, half_rows(batch)))
    elif fault == "answer_altered":
        monkeypatch.setattr(M, "loss_fn",
                            lambda *a: real(*a) * (1.0 + 1e-3))


def prefill_fault(monkeypatch, fault):
    from repro_torch.models import model as M
    real = M.forward

    def half(model, batch, **kw):
        return real(model, half_rows(batch), **kw)

    def altered(model, batch, **kw):
        out = real(model, batch, **kw).clone()
        row = out[0, -1]
        other = int(row.argmin())
        row[other] = row.max() + 1.0
        return out

    monkeypatch.setattr(M, "forward", {"half_batch": half,
                                       "answer_altered": altered}[fault])


@pytest.mark.parametrize("config", sorted(smoke.CONFIGS))
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_sound_run_is_correct(config, kind):
    line = run(config, kind)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1


@pytest.mark.parametrize("config", sorted(smoke.CONFIGS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_training_fault_is_caught(monkeypatch, config, fault):
    train_fault(monkeypatch, fault)
    line = run(config, "train")
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("config", sorted(smoke.CONFIGS))
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_prefill_fault_is_caught(monkeypatch, config, fault):
    prefill_fault(monkeypatch, fault)
    line = run(config, "prefill")
    assert not line["correct"], line["compared"]


def test_a_failed_call_is_not_correct(monkeypatch):
    from repro_torch.models import model as M
    real = M.forward

    def nan(model, batch, **kw):
        return real(model, batch, **kw) * torch.tensor(float("nan"))

    monkeypatch.setattr(M, "forward", nan)
    line = run("qwen3", "prefill")
    assert not line["correct"] and line["failed"] == line["attempted"]
