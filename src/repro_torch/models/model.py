"""Decoder-only LM: init, prefill forward, training loss, KV cache and
decode.

The port's counterpart of ``repro.models.model`` for the dense decoder
families (qwen3, gemma3, starcoder2, phi3), with the LogicNet-FFN (the
paper's fan-in masks and activation quantizers in every FFN) when
``cfg.logicnet_ffn`` is set.  The reference scans stacked layer params
under ``jax.lax.scan``; here parameters are named per layer as the
reference's parameter pytree (``layers.<i>.attn.wq`` is the reference's
``layers.attn.wq[i]``).

* Serving: :class:`LM` holds one :class:`DecoderLayer` per layer in an
  ``nn.ModuleList``, float32 master weights that do not require grad.
  :func:`forward` and :func:`decode_step` read matrices cast to
  ``cfg.compute_dtype`` and 1-D leaves (norm scales) in float32, as the
  reference's ``_cast_weights``; the cast copy is made once and kept until
  a parameter changes.
* Training: :func:`loss_fn` takes a flat ``{name: tensor}`` dict of
  float32 masters that require grad (``launch.steps.make_train_state``)
  and casts each layer's matrices inside the differentiated step, so
  autograd sees the cast, as the reference's ``loss_fn`` does.  Each
  layer runs under ``torch.utils.checkpoint`` when ``cfg.remat`` asks for
  it; attention runs the differentiable chunked form.

A family the port cannot run yet (MoE, SSM or hybrid stacks, enc-dec,
M-RoPE / vision tokens) raises ``NotImplementedError`` naming its ROADMAP
item.

Weights come from :func:`init_params` (the reference's distributions from
a ``torch.Generator``; the LogicNet masks from numpy, so the reference's)
or are carried from the reference with :func:`from_reference`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import attention as ATT
from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import (embed_init, embed_lookup, ffn_apply,
                                       ffn_init, init_rms, lm_logits,
                                       logicnet_ffn_apply, logicnet_ffn_init,
                                       logicnet_masks, rms_norm)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def require_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of a family
    the port cannot run yet; a dense decoder passes."""
    if cfg.moe is not None:
        why = "mixture-of-experts layers (ROADMAP item 9a)"
    elif cfg.is_ssm:
        why = "SSM and hybrid stacks (ROADMAP item 9b)"
    elif cfg.enc_dec:
        why = "encoder-decoder models and cross-attention (ROADMAP item 9c)"
    elif cfg.mrope or cfg.vision_tokens:
        why = "M-RoPE and vision tokens (ROADMAP item 9d)"
    else:
        return
    raise NotImplementedError(f"{cfg.arch_id}: the port does not run {why} "
                              f"yet")


def layer_windows(cfg: ModelCfg) -> list[int]:
    """Per-layer sliding window: 0 = global.  gemma3: N locals then 1
    global."""
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio + 1
        return [0 if i % r == r - 1 else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def _frozen(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class DecoderLayer(nn.Module):
    """One decoder layer: ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo[,q_norm,
    k_norm]}`` and ``ffn.{wi_gate,wi_up,wo[,mask_in,mask_out]}``."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p["ln1"], requires_grad=False)
        self.ln2 = nn.Parameter(p["ln2"], requires_grad=False)
        self.attn = _frozen(p["attn"])
        self.ffn = _frozen(p["ffn"])

    def tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn),
                "ffn": dict(self.ffn)}


class LM(nn.Module):
    """A dense decoder LM's float32 master weights: ``embed.{tok[,head]}``,
    ``final_norm`` and ``layers``."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__()
        require_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(p)
                                    for p in params["layers"])
        self._cast: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def compute_params(self) -> dict:
        """The weights as the compute reads them: matrices in
        ``cfg.compute_dtype``, 1-D leaves in float32.  Cached; rebuilt when
        any parameter has been written since."""
        versions = tuple(p._version for p in self.parameters())
        if self._cast is None or self._cast[0] != versions:
            tree = {"embed": dict(self.embed), "final_norm": self.final_norm,
                    "layers": [layer.tree() for layer in self.layers]}
            with torch.no_grad():
                self._cast = (versions, cast_weights(
                    tree, _dtype(self.cfg.compute_dtype)))
        return self._cast[1]


def cast_weights(tree, cdt: torch.dtype):
    """Matrix leaves (2-D and up) to ``cdt``; 1-D leaves (norm scales) stay
    float32 for numerics, as the reference's ``_cast_weights``.  Under
    autograd the cast is part of the graph."""
    if isinstance(tree, dict):
        return {k: cast_weights(v, cdt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_weights(v, cdt) for v in tree]
    return tree.to(cdt) if tree.dim() >= 2 else tree


def _decoder_layer_init(gen: torch.Generator, cfg: ModelCfg, dtype,
                        masks: tuple | None) -> dict:
    p = {"ln1": init_rms(cfg.d_model, gen.device),
         "ln2": init_rms(cfg.d_model, gen.device),
         "attn": ATT.attn_init(gen, cfg, dtype)}
    if cfg.logicnet_ffn is not None:
        p["ffn"] = logicnet_ffn_init(gen, cfg.d_model, cfg.d_ff, masks,
                                     dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _init_tree(cfg: ModelCfg, gen: torch.Generator) -> dict:
    require_supported(cfg)
    dtype = _dtype(cfg.param_dtype)
    masks = (logicnet_masks(cfg.d_model, cfg.d_ff, cfg.logicnet_ffn)
             if cfg.logicnet_ffn is not None else None)
    return {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                cfg.tie_embeddings),
            "final_norm": init_rms(cfg.d_model, gen.device),
            "layers": [_decoder_layer_init(gen, cfg, dtype, masks)
                       for _ in range(cfg.n_layers)]}


def init_params(cfg: ModelCfg, gen: torch.Generator) -> LM:
    """A model drawn from ``gen`` on ``gen``'s device: projections normal
    x 1/sqrt(fan-in width) as the reference, embeddings normal x 0.02,
    norm scales 0; with the LogicNet-FFN, every layer's masks equal (the
    reference's init draws them once, at seed 0)."""
    return LM(cfg, _init_tree(cfg, gen))


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` reads ``meta``: the init functions make
    their tensors on ``gen.device``, so with it they make tensors of the
    real shapes without storage."""
    device = torch.device("meta")


def _named_leaves(tree, prefix: str = ""):
    """``(dotted name, tensor)`` of a nested dict / list tree, in its
    order (``layers.3.ffn.wo``)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, sub in items:
        yield from _named_leaves(sub, f"{prefix}.{key}" if prefix
                                 else str(key))


def param_shapes(cfg: ModelCfg) -> dict[str, tuple]:
    """Every parameter's name (as ``LM.named_parameters`` and
    :func:`loss_fn` name it) and shape, in the order the init draws them:
    read off the init itself, run on the ``meta`` device (no storage)."""
    return {name: tuple(t.shape)
            for name, t in _named_leaves(_init_tree(cfg, _MetaGenerator()))}


def param_tree(cfg: ModelCfg, params: dict) -> dict:
    """A flat ``{name: tensor}`` dict (``layers.3.ffn.wo``) as the nested
    tree the forward reads: ``{"embed": {...}, "final_norm": ...,
    "layers": [{"ln1", "ln2", "attn": {...}, "ffn": {...}}, ...]}``; the
    tensors themselves, not copies."""
    tree = {"embed": {}, "layers": [{"attn": {}, "ffn": {}}
                                    for _ in range(cfg.n_layers)]}
    for name, t in params.items():
        parts = name.split(".")
        if parts[0] == "layers":
            node = tree["layers"][int(parts[1])]
            for key in parts[2:-1]:
                node = node[key]
        else:
            node = tree
            for key in parts[:-1]:
                node = node[key]
        node[parts[-1]] = t
    return tree


def reference_names(cfg: ModelCfg) -> list[str]:
    """The flattened names of the reference's parameter pytree for ``cfg``
    that :func:`from_reference` takes (``layers.*`` stacked over layers)."""
    names = ["embed.tok", "final_norm", "layers.ln1", "layers.ln2"]
    if not cfg.tie_embeddings:
        names.append("embed.head")
    attn = ["wq", "wk", "wv", "wo"] + (["q_norm", "k_norm"] if cfg.qk_norm
                                       else [])
    names += [f"layers.attn.{k}" for k in attn]
    ffn = ["wi_gate", "wi_up", "wo"] + (["mask_in", "mask_out"]
                                        if cfg.logicnet_ffn is not None
                                        else [])
    names += [f"layers.ffn.{k}" for k in ffn]
    return names


def from_reference(cfg: ModelCfg, arrays: dict, device=None) -> LM:
    """The port's model from the reference's parameters.

    ``arrays`` is the reference's ``init_params`` pytree flattened to numpy
    with dotted names: ``embed.tok``, ``final_norm``, ``layers.ln1`` of
    shape ``(L, d)``, ``layers.attn.wq`` of shape ``(L, d, H, hd)`` and so
    on, stacked over layers as the reference's ``vmap`` init stacks them.
    """
    require_supported(cfg)
    if sorted(arrays) != sorted(reference_names(cfg)):
        raise ValueError(f"the reference's names {sorted(arrays)} do not "
                         f"match the port's {sorted(reference_names(cfg))}")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    layers = [{"attn": {}, "ffn": {}} for _ in range(cfg.n_layers)]
    for name, a in arrays.items():
        parts = name.split(".")
        if parts[0] != "layers":
            continue
        if a.shape[0] != cfg.n_layers:
            raise ValueError(f"{name} stacks {a.shape[0]} layers; "
                             f"{cfg.arch_id} has {cfg.n_layers}")
        for i, layer in enumerate(layers):
            node = layer if len(parts) == 2 else layer[parts[1]]
            node[parts[-1]] = t(a[i])
    embed = {n.split(".", 1)[1]: t(a) for n, a in arrays.items()
             if n.startswith("embed.")}
    return LM(cfg, {"embed": embed, "final_norm": t(arrays["final_norm"]),
                    "layers": layers})


def _ffn(p: dict, cfg: ModelCfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.logicnet_ffn is not None:
        return logicnet_ffn_apply(p, x, cfg.logicnet_ffn)
    return ffn_apply(p, x, cfg.act_fn)


def _attn_block(p: dict, cfg: ModelCfg, h: torch.Tensor,
                positions: torch.Tensor, window: int,
                train: bool = False) -> torch.Tensor:
    a = ATT.attn_apply(p["attn"], cfg, rms_norm(h, p["ln1"], cfg.norm_eps),
                       positions, window=window, train=train)
    h = h + a
    return h + _ffn(p["ffn"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps))


def _decoder(cfg: ModelCfg, w: dict, tokens: torch.Tensor, last_only: bool,
             layer) -> torch.Tensor:
    """Embedding, ``layer(p, h, positions, window)`` for each layer's
    params, final norm, LM head (in the compute dtype)."""
    cdt = _dtype(cfg.compute_dtype)
    h = embed_lookup(w["embed"], tokens, cdt)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for p, window in zip(w["layers"], layer_windows(cfg)):
        h = layer(p, h, positions, window)
    h = rms_norm(h, w["final_norm"], cfg.norm_eps)
    if last_only:
        h = h[:, -1:, :]
    return lm_logits(w["embed"], h, cdt)


def forward(model: LM, batch: dict, last_only: bool = False) -> torch.Tensor:
    """batch: tokens (B, S) -> logits (B, S, vocab) in the compute dtype;
    every layer's attention through the flash-attention kernel.

    ``last_only`` computes the LM head on the final position only (the
    serving-prefill shape: the head matmul on 1 token, not S).
    """
    cfg = model.cfg
    return _decoder(cfg, model.compute_params(), batch["tokens"], last_only,
                    lambda p, h, pos, win: _attn_block(p, cfg, h, pos, win))


def train_forward(params: dict, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """Logits (B, S, vocab) in the compute dtype from a flat dict of float32
    masters, differentiable: each layer casts its matrices inside its own
    block, so with ``cfg.remat`` the casts are recomputed in backward and
    only each layer's input stays alive between the passes.

    ``remat`` "full" (and "dots") runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant): backward recomputes its
    forward, masked-matmul launches included.  The reference's "dots"
    policy keeps the matmul outputs and recomputes the rest; PyTorch's
    selective checkpointing names aten ops, and the FFN's products are an
    autograd function (``MaskedMatmulFn``), so "dots" takes "full" here.
    The policy changes memory and launches, not numbers.
    """
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")
    cdt = _dtype(cfg.compute_dtype)

    def block(p, h, positions, window):
        return _attn_block(cast_weights(p, cdt), cfg, h, positions, window,
                           train=True)

    def layer(p, h, positions, window):
        if cfg.remat == "none":
            return block(p, h, positions, window)
        return checkpoint(block, p, h, positions, window, use_reentrant=False)

    return _decoder(cfg, param_tree(cfg, params), batch["tokens"], False,
                    layer)


def loss_fn(params: dict, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, from float32
    logits (logsumexp less the gold logit), as the reference's ``loss_fn``.
    The reference adds 0.01 x the MoE load-balancing loss, which is 0 for
    every family the port runs (MoE is ROADMAP item 9a)."""
    logits = train_forward(params, cfg, batch).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_cache(cfg: ModelCfg, batch: int, max_seq: int,
               device=None) -> dict:
    """Zeroed bfloat16 KV caches ``k``, ``v`` of shape
    ``(n_layers, batch, max_seq, n_kv_heads, head_dim)``."""
    require_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}


def decode_step(model: LM, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), pos (B,) -> logits
    (B, 1, vocab) and the cache, which is updated in place."""
    cfg = model.cfg
    cdt = _dtype(cfg.compute_dtype)
    w = model.compute_params()
    h = embed_lookup(w["embed"], tokens, cdt)
    for i, (p, window) in enumerate(zip(w["layers"], layer_windows(cfg))):
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        a, _, _ = ATT.attn_decode(p["attn"], cfg, hn, cache["k"][i],
                                  cache["v"][i], pos, window=window)
        h = h + a
        h = h + _ffn(p["ffn"], cfg, rms_norm(h, p["ln2"], cfg.norm_eps))
    h = rms_norm(h, w["final_norm"], cfg.norm_eps)
    return lm_logits(w["embed"], h, cdt), cache
