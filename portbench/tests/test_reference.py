"""The reference against the program at smoke size, both in float32 on the
CPU: the same weights and tokens give the same logits, losses, first
gradients and changes."""

import pytest
import torch

from portbench.harness import check, gen, port, train
from portbench.reference import model as R
from portbench.tests import smoke


@pytest.mark.parametrize("config", sorted(smoke.CONFIGS))
def test_prefill_logits_match(config):
    cfg = dict(smoke.CONFIGS[config], compute_dtype="float32")
    mcfg = port.model_cfg(cfg)
    model = port.serving_model(mcfg, gen.make_params(cfg, 7, "cpu"))
    tokens = torch.randint(0, cfg["vocab"], (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    from repro_torch.models.model import forward
    got = forward(model, {"tokens": tokens}, last_only=True)[:, -1]
    with R.exact_matmuls():
        want = R.last_logits(gen.make_params(cfg, 7, "cpu"), cfg, tokens)
    assert torch.allclose(got.float(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", sorted(smoke.CONFIGS))
def test_training_readings_match(config):
    c = smoke.cell(config, "train", compute_dtype="float32")
    _, _, batches, prog = train.setup(c, 11, "cpu")
    ref = train.reference(c, 11, batches, "cpu")
    nums = check.train_numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    # AdamW's eps-conditioned elements of the SSM's small leaves
    assert nums["change_gap"] < 1e-3


def test_param_names_are_the_programs():
    for cfg in smoke.CONFIGS.values():
        mcfg = port.model_cfg(cfg)
        from repro_torch.models.model import param_shapes
        ours = {n: tuple(s) for n, s, _ in R.param_specs(cfg)}
        assert ours == param_shapes(mcfg)
