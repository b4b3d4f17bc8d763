"""The output check's control at smoke size: the reference put in the
program's place with its products in float8 e4m3 (one precision below the
cells' bfloat16) comes out not correct on three seeds, under the limits a
sound bfloat16 run passes.  At the cells' own size the control is read on
the card by ``portbench/calibrate.py`` (``PERF.md`` gives its readings)."""

import pytest
import torch

from portbench import calibrate
from portbench.harness import check
from portbench.tests import smoke

SEEDS = [21, 22, 23]


def device():
    return "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.parametrize("config,kind", [("qwen3", "train"),
                                         ("qwen3", "prefill"),
                                         ("zamba2", "train")])
def test_control_is_not_correct(config, kind):
    c = smoke.cell(config, kind)
    read = (calibrate.train_readings if kind == "train"
            else calibrate.prefill_readings)
    readings = read(c, [], SEEDS, device())
    for seed in SEEDS:
        ok, compared = check.judge(readings["control"][seed], c.limits)
        assert not ok, (seed, compared)


def test_half_batch_fault_is_not_correct():
    c = smoke.cell("qwen3", "train")
    readings = calibrate.train_readings(c, [], SEEDS, device())
    for seed in SEEDS:
        assert not check.judge(readings["half_batch"][seed], c.limits)[0]
