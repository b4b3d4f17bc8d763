"""What the harness takes from the program (``repro_torch``): its model
config, its state filled by name, its train and prefill steps."""

from __future__ import annotations

import dataclasses


def model_cfg(config: dict):
    """The program's ``ModelCfg`` of a configuration file's run keys; a key
    that is not one of its fields raises."""
    from repro_torch.models.config import LogicNetFFNCfg, ModelCfg, SSMCfg
    fields = {f.name for f in dataclasses.fields(ModelCfg)}
    unknown = sorted(set(config) - fields)
    if unknown:
        raise ValueError(f"config keys {unknown} are not ModelCfg fields")
    kw = dict(config)
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMCfg(**kw["ssm"])
    if kw.get("logicnet_ffn") is not None:
        kw["logicnet_ffn"] = LogicNetFFNCfg(**kw["logicnet_ffn"])
    return ModelCfg(**kw)


def fill(cfg, values: dict) -> dict:
    """``{name: tensor}`` in the program's parameter order
    (``models.model.param_shapes``), each the harness's tensor of that
    name; raises unless the names and shapes are the program's."""
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    ours = {n: tuple(t.shape) for n, t in values.items()}
    if ours != shapes:
        diff = sorted(set(ours.items()) ^ set(shapes.items()))[:6]
        raise ValueError(f"the harness's parameters differ from the "
                         f"program's: {diff}")
    return {n: values[n] for n in shapes}


def train_state(cfg, params: dict) -> dict:
    """The program's train state over ``params`` (leaves that require
    grad) with zero moments."""
    from repro_torch.optim.adamw import init_opt_state
    params = {n: p.requires_grad_() for n, p in fill(cfg, params).items()}
    return {"params": params, "opt": init_opt_state(params)}


def train_step(cfg, traffic: dict):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWCfg
    return make_train_step(cfg, AdamWCfg(
        lr=traffic["lr"], b1=traffic["b1"], b2=traffic["b2"],
        eps=traffic["eps"], weight_decay=traffic["weight_decay"],
        clip_norm=traffic["clip_norm"]))


def serving_model(cfg, params: dict):
    from repro_torch.launch.steps import model_from_state
    return model_from_state(cfg, {"params": fill(cfg, params)})


def prefill_step(cfg):
    from repro_torch.launch.steps import make_prefill_step
    return make_prefill_step(cfg)

