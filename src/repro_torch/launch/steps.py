"""Step builders and ``input_specs`` of the LM zoo: the port of
``repro.launch.steps``.

``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` return
the functions a trainer or a server calls (PyTorch runs eagerly, so
nothing is compiled).  ``make_train_state`` and ``init_params`` draw a
model from a seed on a device; ``abstract_params``,
``abstract_train_state`` and ``input_specs`` describe the same tensors on
the ``meta`` device, allocating nothing.

The train state is ``{"params": {name: tensor}, "opt": {"m", "v",
"step"}}``: float32 masters that require grad (the LogicNet masks too:
their gradient counts in the clipped global norm, as the reference
differentiates its whole parameter tree), float32 moments and an int32
step count, all on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeCell
from repro_torch.models import model as M
from repro_torch.models.config import ModelCfg
from repro_torch.obs.trace import span
from repro_torch.optim.adamw import (AdamWCfg, adamw_update, init_opt_state,
                                     logicnet_mask_fn)
from repro_torch.parallel.local import is_dtensor, local_tensor


def init_params(cfg: ModelCfg, seed: int = 0, device=None) -> M.LM:
    """A model with the reference's init distributions, drawn on
    ``device`` (default ``cuda``) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    return M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))


def abstract_params(cfg: ModelCfg) -> dict[str, torch.Tensor]:
    """Every parameter as a float32 ``meta`` tensor that requires grad, as
    the train state's do: names and shapes, no storage."""
    return {n: torch.empty(s, dtype=torch.float32,
                           device="meta").requires_grad_()
            for n, s in M.param_shapes(cfg).items()}


def abstract_train_state(cfg: ModelCfg) -> dict:
    """The train state's structure on the ``meta`` device (what
    ``checkpoint.restore_checkpoint`` needs as ``like`` to restore onto a
    device without first allocating a fresh state there)."""
    params = abstract_params(cfg)
    return {"params": params, "opt": init_opt_state(params)}


def make_train_state(cfg: ModelCfg, seed: int = 0, device=None) -> dict:
    """``{"params", "opt"}`` for a model drawn from ``seed`` on ``device``
    (default ``cuda``): the parameters as leaf tensors that require grad,
    in ``abstract_params``' order (the order AdamW sums the gradient norm
    in, so a state restored onto an abstract one steps bit for bit as the
    one it was saved from)."""
    named = dict(init_params(cfg, seed, device).named_parameters())
    params = {n: named[n].detach().requires_grad_()
              for n in M.param_shapes(cfg)}
    return {"params": params, "opt": init_opt_state(params)}


def model_from_state(cfg: ModelCfg, state: dict) -> M.LM:
    """The serving model over a train state's parameters (the same
    storage, detached): what ``make_prefill_step`` and
    ``make_decode_step`` serve after training."""
    return M.LM(cfg, M.param_tree(cfg, {n: p.detach() for n, p in
                                        state["params"].items()}))


def restore_model(cfg: ModelCfg, directory: str, device=None
                  ) -> tuple[int, M.LM]:
    """``(step, model)``: the serving model over the parameters of the
    latest checkpoint a ``TrainLoop`` wrote to ``directory`` (its moments
    are not read), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    like = {"state": {"params": abstract_params(cfg)},
            "step": np.asarray(0)}
    out = CheckpointManager(directory).restore_latest(like, device=dev)
    if out is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    _, tree = out
    return int(tree["step"]), model_from_state(cfg, tree["state"])


def decays(name: str, p: torch.Tensor) -> bool:
    """AdamW's weight-decay rule (rank >= 2) read on the reference's
    leaves, which stack each list's layers: so a layer's vectors (its
    norms, an SSM's ``a_log``, ``d_skip`` and ``dt_bias``) decay, and a
    hybrid's shared layer's vectors, one layer's, do not."""
    return M.reference_ndim(name, p) >= 2


def grad_shardings(state_shardings: dict) -> dict:
    """The parameters' placements out of :func:`parallel.sharding.
    shardings_for_tree` of a train state (``{"params.<name>": placements,
    "opt.m.<name>": ...}``): ``{name: placements}``, what
    :func:`make_train_step` takes as ``grad_shardings``."""
    return {n.split(".", 1)[1]: pl for n, pl in state_shardings.items()
            if n.startswith("params.")}


def make_train_step(cfg: ModelCfg, opt_cfg: AdamWCfg | None = None,
                    grad_shardings: dict | None = None):
    """``train_step(state, batch) -> (state, loss)``: the loss and the
    gradient of every parameter (masks included), then one AdamW update
    in place (the LogicNet masks applied to their weights' gradients and
    values when ``cfg.logicnet_ffn`` is set).  The step count and every
    per-step scalar of the update stay on the device.

    The reference's step is a pure function, and its loop drops the new
    state of a step whose loss is not finite.  This step updates in
    place, so it reads the loss first (one wait for the device a step;
    the loop reads it anyway) and, when it is not finite, returns the
    state untouched: parameters, moments and step count bit for bit as
    they were.

    On a mesh (DTensor parameters) each gradient comes back in the
    placements its backward gave it (a replicated leaf's as a partial sum
    over the batch axes); AdamW's per-leaf arithmetic then redistributes
    it where it meets the parameter.  With ``grad_shardings`` (``{name:
    placements}``, :func:`grad_shardings`) each gradient is redistributed
    to its parameter's placements first: the reduce-scatter of the
    reference's ``--grad-rs``.  The NaN guard reads the loss whole.

    Step spans (``obs.trace.span``) name ``train_step`` and, inside it,
    ``forward``, ``backward``, ``nan_guard`` and ``adamw``.
    """
    opt_cfg = opt_cfg or AdamWCfg(lr=3e-4)
    mask_fn = logicnet_mask_fn if cfg.logicnet_ffn is not None else None

    def step(state: dict, batch: dict):
        params = state["params"]
        with span("forward"):
            loss = M.loss_fn(params, cfg, batch)
        with span("backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        loss = local_tensor(loss.detach())
        with span("nan_guard"):
            # a meta loss (the dry-run's) has no value to read
            bad = loss.device.type != "meta" and not bool(
                torch.isfinite(loss))
        if bad:
            return state, loss
        if grad_shardings is not None:
            grads = [g.redistribute(g.device_mesh, grad_shardings[n])
                     if is_dtensor(g) else g
                     for n, g in zip(params, grads)]
        with span("adamw"):
            adamw_update(opt_cfg, params, dict(zip(params, grads)),
                         state["opt"], mask_fn=mask_fn, decay_fn=decays)
        return state, loss

    def train_step(state: dict, batch: dict):
        with span("train_step"):
            return step(state, batch)

    return train_step


def make_prefill_step(cfg: ModelCfg):
    """``prefill_step(model, batch) -> (B, vocab)`` logits of each
    sequence's last position; every layer's attention goes through the
    flash-attention kernel.  The batch's ``vision_embeds`` or ``frames``
    pass through to the model with its tokens.  A call is the step span
    ``prefill_step``."""
    def prefill_step(model: M.LM, batch: dict) -> torch.Tensor:
        with span("prefill_step"):
            return M.forward(model, batch, last_only=True)[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelCfg):
    """``serve_step(model, cache, tokens, pos) -> ((B, vocab) logits,
    cache)``; the cache is updated in place."""
    def serve_step(model: M.LM, cache: dict, tokens: torch.Tensor,
                   pos: torch.Tensor):
        logits, cache = M.decode_step(model, cache, tokens, pos)
        return logits[:, 0, :], cache

    return serve_step


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, cell: ShapeCell) -> dict:
    """``meta`` tensors of every model input of the cell, in the
    reference's shapes and dtypes:

    train:   {batch: {tokens, labels[, vision_embeds | frames]}}
    prefill: {batch: {tokens[, vision_embeds | frames]}}
    decode:  {cache, tokens, pos}, the cache as ``models.model.init_cache``
             makes it (``k``, ``v``; an encoder-decoder's ``mem_k``,
             ``mem_v``; an SSM stack's ``ssm.{ssd, conv}`` and a hybrid's
             ``shared_k``, ``shared_v``)

    ``vision_embeds`` (B, vision_tokens, d_model) and ``frames`` (B,
    enc_frames, d_model) are bfloat16, the stub frontends' outputs.
    """
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), torch.int32)}
        if cell.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32)
        if cfg.vision_tokens > 0:
            batch["vision_embeds"] = _meta((b, cfg.vision_tokens,
                                            cfg.d_model), torch.bfloat16)
        if cfg.enc_dec:
            batch["frames"] = _meta((b, cfg.enc_frames, cfg.d_model),
                                    torch.bfloat16)
        return {"batch": batch}
    # decode: a cache sized to seq_len, one new token
    return {"cache": M.map_specs(M.cache_specs(cfg, b, s), _meta),
            "tokens": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32)}
