"""The LM zoo: init, prefill forward, training loss, KV / SSM caches and
decode.

The port's counterpart of ``repro.models.model`` for the dense decoder
families (qwen3, gemma3, starcoder2, phi3), the mixture-of-experts
decoders (qwen3-moe, olmoe: a ``moe`` FFN, ``models.moe``), the SSM stack
(mamba2: ``ssm_layers``, ``models.ssm``), the hybrid (zamba2: one
``shared_attn`` decoder layer whose weights serve every
``hybrid_attn_every``-th site between the SSM layers), the VLM (qwen2-vl:
M-RoPE positions and ``vision_embeds`` in the first ``vision_tokens``
positions) and the encoder-decoder (whisper: ``enc_layers`` over the
``frames`` with ``pos_emb_enc``, then ``dec_layers`` with cross-attention
to the encoder's memory), with the LogicNet-FFN (the paper's fan-in masks
and activation quantizers in every decoder FFN) when ``cfg.logicnet_ffn``
is set.  The reference scans stacked layer
params under ``jax.lax.scan``; here parameters are named per layer as
the reference's parameter pytree (``layers.<i>.attn.wq`` is the
reference's ``layers.attn.wq[i]``, ``ssm_layers.<i>.ssm.in_proj`` its
``ssm_layers.ssm.in_proj[i]``; ``shared_attn.*`` is not stacked).

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

Step spans (``obs.trace.span``, one check while off) name each decoder
layer's ``attn`` and ``ffn`` (each with its norm), the ``head`` (final
norm and logits) and the ``loss``; a recomputed layer opens its spans
again.

The MoE layers' load-balancing loss is summed over layers as the
reference's layer scan carries it (:func:`forward` with ``with_aux``),
and :func:`loss_fn` adds 0.01 x that sum.

Whisper's encoder runs in float32 at bfloat16 compute, as the
reference's does: ``pos_emb_enc`` is a float32 leaf outside the layers'
cast, so ``frames + pos_emb_enc`` is float32 and every encoder product
promotes its bfloat16 weights to it; the memory, its cross-attention K
and V, and the cross-attention itself are float32 (bfloat16 queries
promoted), its output bfloat16.  Decode reads the memory's K and V from
the cache (``mem_k``, ``mem_v``, bfloat16 as the reference's
``init_cache`` makes them), which :func:`write_cross_memory` fills.

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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import (embed_init, embed_lookup, ffn_apply,
                                       ffn_init, init_rms, lm_logits,
                                       logicnet_ffn_apply, logicnet_ffn_init,
                                       logicnet_masks, normal_init,
                                       rms_norm)
from repro_torch.obs.trace import span
from repro_torch.parallel.ctx import constrain
from repro_torch.parallel.local import (gather_fsdp, replicate_like,
                                        vocab_gather)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


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
    k_norm]}`` and either ``ffn.{wi_gate,wi_up,wo[,mask_in,mask_out]}`` or,
    in a mixture-of-experts model, ``moe.{router,wi_gate,wi_up,wo}``."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p["ln1"], requires_grad=False)
        self.ln2 = nn.Parameter(p["ln2"], requires_grad=False)
        self.attn = _frozen(p["attn"])
        self.ffn_key = "moe" if "moe" in p else "ffn"
        setattr(self, self.ffn_key, _frozen(p[self.ffn_key]))

    def tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn),
                self.ffn_key: dict(getattr(self, self.ffn_key))}


class EncoderLayer(nn.Module):
    """One encoder layer (whisper): ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``
    and ``ffn.{wi_gate,wi_up,wo}``."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p["ln1"], requires_grad=False)
        self.ln2 = nn.Parameter(p["ln2"], requires_grad=False)
        self.attn = _frozen(p["attn"])
        self.ffn = _frozen(p["ffn"])

    def tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2, "attn": dict(self.attn),
                "ffn": dict(self.ffn)}


class CrossDecoderLayer(nn.Module):
    """One decoder layer of an encoder-decoder (whisper): ``ln1``-``ln3``,
    self-attention ``attn``, cross-attention ``xattn`` (both
    ``{wq,wk,wv,wo}``) and ``ffn.{wi_gate,wi_up,wo}``."""

    def __init__(self, p: dict):
        super().__init__()
        for key in ("ln1", "ln2", "ln3"):
            setattr(self, key, nn.Parameter(p[key], requires_grad=False))
        self.attn = _frozen(p["attn"])
        self.xattn = _frozen(p["xattn"])
        self.ffn = _frozen(p["ffn"])

    def tree(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2, "ln3": self.ln3,
                "attn": dict(self.attn), "xattn": dict(self.xattn),
                "ffn": dict(self.ffn)}


class SSMLayer(nn.Module):
    """One SSM layer: ``ln`` and ``ssm.{in_proj,conv_w,conv_b,a_log,d_skip,
    dt_bias,norm,out_proj}``."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln = nn.Parameter(p["ln"], requires_grad=False)
        self.ssm = _frozen(p["ssm"])

    def tree(self) -> dict:
        return {"ln": self.ln, "ssm": dict(self.ssm)}


class LM(nn.Module):
    """An LM's float32 master weights: ``embed.{tok[,head]}``,
    ``final_norm`` and either ``layers`` (decoders), ``ssm_layers`` (SSM
    stacks) with, in a hybrid, the one ``shared_attn`` layer, or an
    encoder-decoder's ``pos_emb_enc``, ``enc_layers``, ``dec_layers`` and
    ``enc_final_norm``."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        if cfg.is_ssm:
            self.ssm_layers = nn.ModuleList(SSMLayer(p)
                                            for p in params["ssm_layers"])
            if cfg.is_hybrid:
                self.shared_attn = DecoderLayer(params["shared_attn"])
        elif cfg.enc_dec:
            self.pos_emb_enc = nn.Parameter(params["pos_emb_enc"],
                                            requires_grad=False)
            self.enc_layers = nn.ModuleList(EncoderLayer(p)
                                            for p in params["enc_layers"])
            self.dec_layers = nn.ModuleList(CrossDecoderLayer(p)
                                            for p in params["dec_layers"])
            self.enc_final_norm = nn.Parameter(params["enc_final_norm"],
                                               requires_grad=False)
        else:
            self.layers = nn.ModuleList(DecoderLayer(p)
                                        for p in params["layers"])
        self._cast: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def tree(self) -> dict:
        """The master weights as the nested tree the forward reads (the
        tensors themselves): ``LM(other_cfg, model.tree())`` is another
        view of the same storage, at another compute dtype say."""
        tree = {"embed": dict(self.embed), "final_norm": self.final_norm}
        if self.cfg.is_ssm:
            tree["ssm_layers"] = [layer.tree() for layer in self.ssm_layers]
            if self.cfg.is_hybrid:
                tree["shared_attn"] = self.shared_attn.tree()
        elif self.cfg.enc_dec:
            tree["pos_emb_enc"] = self.pos_emb_enc
            tree["enc_layers"] = [layer.tree() for layer in self.enc_layers]
            tree["dec_layers"] = [layer.tree() for layer in self.dec_layers]
            tree["enc_final_norm"] = self.enc_final_norm
        else:
            tree["layers"] = [layer.tree() for layer in self.layers]
        return tree

    def compute_params(self) -> dict:
        """The weights as the compute reads them: matrices in
        ``cfg.compute_dtype``, 1-D leaves and ``pos_emb_enc`` in float32.
        Cached; rebuilt when any parameter has been written since."""
        versions = tuple(p._version for p in self.parameters())
        if self._cast is None or self._cast[0] != versions:
            with torch.no_grad():
                self._cast = (versions, _cast_tree(
                    self.tree(), _dtype(self.cfg.compute_dtype)))
        return self._cast[1]


# top-level leaves the reference reads as they are: its ``_cast_weights``
# casts inside the layers only (and ``embed_lookup`` / ``lm_logits`` cast
# the embedding themselves)
_UNCAST = ("pos_emb_enc",)


def _cast_tree(tree: dict, cdt: torch.dtype) -> dict:
    """A model's whole tree as the compute reads it: :func:`cast_weights`
    but for the ``_UNCAST`` leaves, which stay float32."""
    out = cast_weights({k: v for k, v in tree.items() if k not in _UNCAST},
                       cdt)
    out.update({k: tree[k] for k in _UNCAST if k in tree})
    return out


def cast_weights(tree, cdt: torch.dtype):
    """Matrix leaves (2-D and up) to ``cdt``; 1-D leaves (norm scales,
    biases, ``a_log``, ...) stay float32 for numerics, as the reference's
    ``_cast_weights``.  Under autograd the cast is part of the graph.  On
    a mesh each cast matrix is gathered over the FSDP axes
    (``parallel.local.gather_fsdp``): the layer that casts its weights
    gathers them, and its backward reduce-scatters their gradients."""
    if isinstance(tree, dict):
        return {k: cast_weights(v, cdt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_weights(v, cdt) for v in tree]
    return gather_fsdp(tree.to(cdt)) if tree.dim() >= 2 else tree


def _decoder_layer_init(gen: torch.Generator, cfg: ModelCfg, dtype,
                        masks: tuple | None) -> dict:
    p = {"ln1": init_rms(cfg.d_model, gen.device),
         "ln2": init_rms(cfg.d_model, gen.device),
         "attn": ATT.attn_init(gen, cfg, dtype)}
    if cfg.moe is not None:
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    elif cfg.logicnet_ffn is not None:
        p["ffn"] = logicnet_ffn_init(gen, cfg.d_model, cfg.d_ff, masks,
                                     dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _n_sites(cfg: ModelCfg) -> int:
    """Sites of a hybrid's shared attention layer: one before every
    ``hybrid_attn_every`` SSM layers."""
    assert cfg.n_layers % cfg.hybrid_attn_every == 0, \
        "hybrid stacks run super-layers: n_layers % attn_every == 0"
    return cfg.n_layers // cfg.hybrid_attn_every


def _attn_every(cfg: ModelCfg) -> int:
    """A hybrid runs its shared attention layer before every this many SSM
    layers; 0 for a plain SSM stack."""
    if not cfg.is_hybrid:
        return 0
    _n_sites(cfg)
    return cfg.hybrid_attn_every


def _enc_layer_init(gen: torch.Generator, cfg: ModelCfg, dtype) -> dict:
    return {"ln1": init_rms(cfg.d_model, gen.device),
            "ln2": init_rms(cfg.d_model, gen.device),
            "attn": ATT.attn_init(gen, cfg, dtype),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def _dec_xattn_layer_init(gen: torch.Generator, cfg: ModelCfg,
                          dtype) -> dict:
    return {"ln1": init_rms(cfg.d_model, gen.device),
            "ln2": init_rms(cfg.d_model, gen.device),
            "ln3": init_rms(cfg.d_model, gen.device),
            "attn": ATT.attn_init(gen, cfg, dtype),
            "xattn": ATT.attn_init(gen, cfg, dtype),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def _init_tree(cfg: ModelCfg, gen: torch.Generator) -> dict:
    dtype = _dtype(cfg.param_dtype)
    masks = (logicnet_masks(cfg.d_model, cfg.d_ff, cfg.logicnet_ffn)
             if cfg.logicnet_ffn is not None else None)
    tree = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                cfg.tie_embeddings),
            "final_norm": init_rms(cfg.d_model, gen.device)}
    if cfg.is_ssm:
        tree["ssm_layers"] = [{"ln": init_rms(cfg.d_model, gen.device),
                               "ssm": SSM.ssm_init(gen, cfg, dtype)}
                              for _ in range(cfg.n_layers)]
        if cfg.is_hybrid:
            _n_sites(cfg)
            tree["shared_attn"] = _decoder_layer_init(gen, cfg, dtype, masks)
    elif cfg.enc_dec:
        tree["pos_emb_enc"] = normal_init((cfg.enc_frames, cfg.d_model),
                                          0.01, gen, dtype)
        tree["enc_layers"] = [_enc_layer_init(gen, cfg, dtype)
                              for _ in range(cfg.n_enc_layers)]
        tree["dec_layers"] = [_dec_xattn_layer_init(gen, cfg, dtype)
                              for _ in range(cfg.n_layers)]
        tree["enc_final_norm"] = init_rms(cfg.d_model, gen.device)
    else:
        tree["layers"] = [_decoder_layer_init(gen, cfg, dtype, masks)
                          for _ in range(cfg.n_layers)]
    return tree


def init_params(cfg: ModelCfg, gen: torch.Generator) -> LM:
    """A model drawn from ``gen`` on ``gen``'s device: projections normal
    x 1/sqrt(fan-in width) as the reference, embeddings normal x 0.02,
    norm scales 0, MoE routers and experts and SSM blocks as the
    reference's ``moe_init`` / ``ssm_init``, an encoder-decoder's
    ``pos_emb_enc`` normal x 0.01; with the LogicNet-FFN, every
    layer's masks equal (the reference's init draws them once, at seed
    0)."""
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


# the parameter lists stacked over layers in the reference's pytree
_STACKED = ("layers", "ssm_layers", "enc_layers", "dec_layers")


def stacked_layers(cfg: ModelCfg, stack: str) -> int:
    """Layers a stacked list holds: ``n_enc_layers`` for ``enc_layers``,
    ``n_layers`` for the others."""
    return cfg.n_enc_layers if stack == "enc_layers" else cfg.n_layers


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of the reference's leaf that holds parameter ``name``: one
    more than ``t``'s for a layer of a stacked list (``layers.3.ln1`` is a
    row of the reference's ``(L, d)`` ``layers.ln1``), ``t``'s own
    otherwise (a hybrid's ``shared_attn.ln1`` is one layer's)."""
    return t.dim() + (name.split(".", 1)[0] in _STACKED)


def param_tree(cfg: ModelCfg, params: dict) -> dict:
    """A flat ``{name: tensor}`` dict (``layers.3.ffn.wo``) as the nested
    tree the forward reads: ``{"embed": {...}, "final_norm": ...,
    "layers": [{"ln1", "ln2", "attn": {...}, "ffn" or "moe": {...}}, ...]}``
    or, for an SSM stack, ``"ssm_layers": [{"ln", "ssm": {...}}, ...]`` and
    a hybrid's ``"shared_attn"``, or an encoder-decoder's ``enc_layers``
    and ``dec_layers`` lists beside ``pos_emb_enc`` and
    ``enc_final_norm``; the tensors themselves, not copies."""
    tree: dict = {}
    for name, t in params.items():
        parts = name.split(".")
        node = tree
        if parts[0] in _STACKED:
            node = node.setdefault(parts[0], [{} for _ in range(
                stacked_layers(cfg, parts[0]))])
            node, parts = node[int(parts[1])], parts[2:]
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return tree


SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
              "norm", "out_proj")


def _attn_names(cfg: ModelCfg, prefix: str) -> list[str]:
    attn = ["wq", "wk", "wv", "wo"] + (["q_norm", "k_norm"] if cfg.qk_norm
                                       else [])
    return [f"{prefix}.{k}" for k in attn]


_FFN = ("wi_gate", "wi_up", "wo")


def _decoder_layer_names(cfg: ModelCfg, prefix: str) -> list[str]:
    names = [f"{prefix}.ln1", f"{prefix}.ln2"]
    names += _attn_names(cfg, f"{prefix}.attn")
    if cfg.moe is not None:
        return names + [f"{prefix}.moe.{k}" for k in
                        ("router", "wi_gate", "wi_up", "wo")]
    ffn = ["wi_gate", "wi_up", "wo"] + (["mask_in", "mask_out"]
                                        if cfg.logicnet_ffn is not None
                                        else [])
    return names + [f"{prefix}.ffn.{k}" for k in ffn]


def reference_names(cfg: ModelCfg) -> list[str]:
    """The flattened names of the reference's parameter pytree for ``cfg``
    that :func:`from_reference` takes (``layers.*``, ``ssm_layers.*``,
    ``enc_layers.*`` and ``dec_layers.*`` stacked over layers, a hybrid's
    ``shared_attn.*`` not)."""
    names = ["embed.tok", "final_norm"]
    if not cfg.tie_embeddings:
        names.append("embed.head")
    if cfg.enc_dec:
        names += ["pos_emb_enc", "enc_final_norm", "enc_layers.ln1",
                  "enc_layers.ln2"] + _attn_names(cfg, "enc_layers.attn")
        names += [f"enc_layers.ffn.{k}" for k in _FFN]
        names += [f"dec_layers.ln{i}" for i in (1, 2, 3)]
        names += (_attn_names(cfg, "dec_layers.attn")
                  + _attn_names(cfg, "dec_layers.xattn"))
        return names + [f"dec_layers.ffn.{k}" for k in _FFN]
    if not cfg.is_ssm:
        return names + _decoder_layer_names(cfg, "layers")
    names += ["ssm_layers.ln"] + [f"ssm_layers.ssm.{k}" for k in SSM_LEAVES]
    if cfg.is_hybrid:
        names += _decoder_layer_names(cfg, "shared_attn")
    return names


def from_reference(cfg: ModelCfg, arrays: dict, device=None) -> LM:
    """The port's model from the reference's parameters.

    ``arrays`` is the reference's ``init_params`` pytree flattened to numpy
    with dotted names: ``embed.tok``, ``final_norm``, ``layers.ln1`` of
    shape ``(L, d)``, ``layers.attn.wq`` of shape ``(L, d, H, hd)``,
    ``ssm_layers.ssm.in_proj`` of shape ``(L, d, proj)`` and so on, stacked
    over layers as the reference's ``vmap`` init stacks them
    (``enc_layers.*`` over ``n_enc_layers``); a hybrid's ``shared_attn.*``
    is one layer's, unstacked.
    """
    if sorted(arrays) != sorted(reference_names(cfg)):
        raise ValueError(f"the reference's names {sorted(arrays)} do not "
                         f"match the port's {sorted(reference_names(cfg))}")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    tree: dict = {}
    for name, a in arrays.items():
        parts = name.split(".")
        if parts[0] not in _STACKED:
            node = tree
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = t(a)
            continue
        n = stacked_layers(cfg, parts[0])
        if a.shape[0] != n:
            raise ValueError(f"{name} stacks {a.shape[0]} layers; "
                             f"{cfg.arch_id} has {n}")
        layers = tree.setdefault(parts[0], [{} for _ in range(n)])
        for i, layer in enumerate(layers):
            node = layer
            for key in parts[1:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = t(a[i])
    return LM(cfg, tree)


def _ffn(p: dict, cfg: ModelCfg, x: torch.Tensor):
    """A decoder layer's FFN on ``x``: ``(out, the MoE aux loss or
    None)``."""
    if cfg.moe is not None:
        return MOE.moe_apply(p["moe"], cfg, x)
    if cfg.logicnet_ffn is not None:
        return logicnet_ffn_apply(p["ffn"], x, cfg.logicnet_ffn), None
    return ffn_apply(p["ffn"], x, cfg.act_fn), None


_ACT = ("act_batch", None, "act_embed")


def _add(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The residual ``h + a``, ``a`` constrained to the residual stream's
    layout first: on a mesh a row-parallel product's partial sum is
    reduced here (DTensor's own choice at the add keeps it partial and
    drags it through the next norm)."""
    return h + constrain(a, _ACT)


def _attn_block(p: dict, cfg: ModelCfg, h: torch.Tensor,
                positions: torch.Tensor, window: int, train: bool = False):
    """A decoder layer: ``(h, the MoE aux loss or None)``."""
    h = constrain(h, _ACT)
    with span("attn"):
        a = ATT.attn_apply(p["attn"], cfg,
                           rms_norm(h, p["ln1"], cfg.norm_eps), positions,
                           window=window, train=train)
    h = _add(h, a)
    with span("ffn"):
        f, aux = _ffn(p, cfg, rms_norm(h, p["ln2"], cfg.norm_eps))
    return _add(h, f), aux


def _ssm_block(p: dict, cfg: ModelCfg, h: torch.Tensor) -> torch.Tensor:
    return _add(h, SSM.ssm_apply(p["ssm"], cfg, rms_norm(h, p["ln"],
                                                         cfg.norm_eps)))


def _forward_decoder(cfg: ModelCfg, w: dict, h: torch.Tensor,
                     positions: torch.Tensor, attn_layer):
    """A decoder's layers: ``attn_layer(p, h, positions, window)`` for each
    layer's params; ``(h, the MoE aux losses summed, float32)``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, window in zip(w["layers"], layer_windows(cfg)):
        h, a = attn_layer(p, h, positions, window)
        if a is not None:
            aux = replicate_like(aux, a) + a
    return h, aux


def _forward_ssm(cfg: ModelCfg, w: dict, h: torch.Tensor,
                 positions: torch.Tensor, attn_layer, ssm_layer
                 ) -> torch.Tensor:
    """An SSM stack's layers: ``ssm_layer(p, h)`` for each; a hybrid runs
    ``attn_layer`` on its shared layer (window 0) before every
    ``hybrid_attn_every`` of them, the reference's super-layers."""
    every = _attn_every(cfg)
    for i, p in enumerate(w["ssm_layers"]):
        if every and i % every == 0:
            h, _ = attn_layer(w["shared_attn"], h, positions, 0)
        h = ssm_layer(p, h)
    return h


def _encoder_block(p: dict, cfg: ModelCfg, h: torch.Tensor,
                   positions: torch.Tensor, train: bool = False
                   ) -> torch.Tensor:
    """An encoder layer, non-causal, no window.  Its matrices promote to
    ``h``'s type (float32: the reference's float32 encoder at bfloat16
    compute reads its bfloat16 weights widened)."""
    p = cast_weights(p, torch.promote_types(h.dtype,
                                            _dtype(cfg.compute_dtype)))
    h = _add(h, ATT.attn_apply(p["attn"], cfg, rms_norm(h, p["ln1"],
                                                        cfg.norm_eps),
                               positions, window=0, causal=False,
                               train=train))
    return _add(h, ffn_apply(p["ffn"], rms_norm(h, p["ln2"], cfg.norm_eps),
                             cfg.act_fn))


def _cross_block(p: dict, cfg: ModelCfg, h: torch.Tensor,
                 positions: torch.Tensor, memory: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
    """An encoder-decoder's decoder layer: causal self-attention, then
    cross-attention to ``memory`` (its K and V projected here), then the
    FFN."""
    h = _add(h, ATT.attn_apply(p["attn"], cfg, rms_norm(h, p["ln1"],
                                                        cfg.norm_eps),
                               positions, window=0, causal=True,
                               train=train))
    mk, mv = ATT.cross_memory(p["xattn"], cfg, memory)
    h = _add(h, ATT.cross_attn_apply(p["xattn"], cfg,
                                     rms_norm(h, p["ln2"], cfg.norm_eps),
                                     mk, mv, train=train))
    return _add(h, ffn_apply(p["ffn"], rms_norm(h, p["ln3"], cfg.norm_eps),
                             cfg.act_fn))


def _forward_encoder(cfg: ModelCfg, w: dict, frames: torch.Tensor,
                     enc_layer) -> torch.Tensor:
    """The encoder's memory (B, F, D): ``frames`` plus the float32
    ``pos_emb_enc`` (so float32, as in the reference), ``enc_layer(p, h,
    positions)`` for each layer, then ``enc_final_norm``."""
    h = constrain(frames + w["pos_emb_enc"][None, :frames.shape[1], :],
                  _ACT)
    b, f = frames.shape[:2]
    positions = torch.arange(f, device=frames.device).expand(b, f)
    for p in w["enc_layers"]:
        h = enc_layer(p, h, positions)
    return rms_norm(h, w["enc_final_norm"], cfg.norm_eps)


def _positions(cfg: ModelCfg, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1, or with ``cfg.mrope`` the reference's
    M-RoPE stub (B, S, 3): vision tokens at (t=0, h, w) on a
    ``side`` x ``side`` grid, text tokens at ``s - vision_tokens + side``
    in all three streams."""
    b, s = tokens.shape
    seq = torch.arange(s, device=tokens.device).expand(b, s)
    if not cfg.mrope:
        return seq
    v = cfg.vision_tokens
    side = max(1, int(v ** 0.5))
    vis = seq < v
    text = seq - v + side
    return torch.stack([torch.where(vis, 0, text),
                        torch.where(vis, seq // side, text),
                        torch.where(vis, seq % side, text)], dim=-1)


def _decoder(cfg: ModelCfg, w: dict, batch: dict, last_only: bool,
             blocks: dict):
    """Embedding (``vision_embeds`` in the first ``vision_tokens``
    positions when the batch has them), the layer stack, final norm, LM
    head (in the compute dtype): ``(logits, aux)``, aux the MoE
    load-balancing losses summed over layers (float32; 0 without MoE).
    ``blocks`` holds the layer functions: ``attn(p, h, positions,
    window)``, ``ssm(p, h)``, ``enc(p, h, positions)`` and ``cross(p, h,
    positions, memory)``."""
    cdt = _dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    h = embed_lookup(w["embed"], tokens, cdt)
    if cfg.vision_tokens > 0 and "vision_embeds" in batch:
        h = torch.cat([batch["vision_embeds"].to(cdt),
                       h[:, cfg.vision_tokens:]], dim=1)
    positions = _positions(cfg, tokens)
    h = constrain(h, ("act_batch", None, "act_embed"))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.is_ssm:
        h = _forward_ssm(cfg, w, h, positions, blocks["attn"],
                         blocks["ssm"])
    elif cfg.enc_dec:
        memory = _forward_encoder(cfg, w, batch["frames"].to(cdt),
                                  blocks["enc"])
        for p in w["dec_layers"]:
            h = blocks["cross"](p, h, positions, memory)
    else:
        h, aux = _forward_decoder(cfg, w, h, positions, blocks["attn"])
    with span("head"):
        h = rms_norm(h, w["final_norm"], cfg.norm_eps)
        if last_only:
            h = h[:, -1:, :]
        logits = constrain(lm_logits(w["embed"], h, cdt),
                           ("act_batch", None, "act_vocab"))
    return logits, aux


def _serve_blocks(cfg: ModelCfg) -> dict:
    """The layer functions of :func:`_decoder` for serving: attention
    through the flash kernel."""
    return {"attn": lambda p, h, pos, win: _attn_block(p, cfg, h, pos, win),
            "ssm": lambda p, h: _ssm_block(p, cfg, h),
            "enc": lambda p, h, pos: _encoder_block(p, cfg, h, pos),
            "cross": lambda p, h, pos, mem: _cross_block(p, cfg, h, pos,
                                                         mem)}


def forward(model: LM, batch: dict, last_only: bool = False,
            with_aux: bool = False):
    """batch: tokens (B, S) [+ vision_embeds (B, vision_tokens, D) | frames
    (B, F, D)] -> logits (B, S, vocab) in the compute dtype (with
    ``with_aux``, ``(logits, aux)``: the MoE load-balancing loss summed
    over layers, float32, 0 for other families); every attention layer
    (an encoder's, a decoder's self- and cross-attention) through the
    flash-attention kernel.

    ``last_only`` computes the LM head on the final position only (the
    serving-prefill shape: the head matmul on 1 token, not S).
    """
    cfg = model.cfg
    logits, aux = _decoder(cfg, model.compute_params(), batch, last_only,
                           _serve_blocks(cfg))
    return (logits, aux) if with_aux else logits


def train_forward(params: dict, cfg: ModelCfg, batch: dict,
                  with_aux: bool = False):
    """Logits (B, S, vocab) in the compute dtype (and with ``with_aux``
    the summed MoE aux loss, as :func:`forward`) from a flat dict of
    float32 masters, differentiable: each layer casts its matrices inside
    its own block, so with ``cfg.remat`` the casts are recomputed in
    backward and only each layer's input stays alive between the passes.

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

    def attn_block(p, h, positions, window):
        return _attn_block(cast_weights(p, cdt), cfg, h, positions, window,
                           train=True)

    def ssm_block(p, h):
        return _ssm_block(cast_weights(p, cdt), cfg, h)

    def enc_block(p, h, positions):
        return _encoder_block(cast_weights(p, cdt), cfg, h, positions,
                              train=True)

    def cross_block(p, h, positions, memory):
        return _cross_block(cast_weights(p, cdt), cfg, h, positions, memory,
                            train=True)

    def remat(block):
        if cfg.remat == "none":
            return block
        return lambda *args: checkpoint(block, *args, use_reentrant=False)

    blocks = {"attn": attn_block, "ssm": ssm_block, "enc": enc_block,
              "cross": cross_block}
    logits, aux = _decoder(cfg, param_tree(cfg, params), batch, False,
                           {k: remat(f) for k, f in blocks.items()})
    return (logits, aux) if with_aux else logits


def loss_fn(params: dict, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, from float32
    logits (logsumexp less the gold logit), plus 0.01 x the MoE
    load-balancing loss summed over layers, as the reference's
    ``loss_fn``.  On a mesh the logits stay sharded over the vocab: the
    gold logit is a vocab-parallel gather (``parallel.local.
    vocab_gather``)."""
    logits, aux = train_forward(params, cfg, batch, with_aux=True)
    with span("loss"):
        logits = logits.float()
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = vocab_gather(logits, labels.clamp(min=0))
        mask = (labels >= 0).float()
        nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll + 0.01 * replicate_like(aux, nll)


def cache_specs(cfg: ModelCfg, batch: int, max_seq: int) -> dict:
    """The decode cache as a tree of ``(shape, dtype)``, the reference's
    ``init_cache`` tree: ``k``, ``v`` (n_layers, batch, max_seq, Hkv, hd)
    bfloat16 for decoders, and an encoder-decoder's ``mem_k``, ``mem_v``
    (n_layers, batch, enc_frames, Hkv, hd) bfloat16; for SSM stacks
    ``ssm.{ssd, conv}``, each layer's float32 decode state stacked over
    layers, and in a hybrid ``shared_k``, ``shared_v`` (n_sites, batch,
    max_seq, Hkv, hd) bfloat16."""
    hd = cfg.resolved_head_dim
    if not cfg.is_ssm:
        kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd),
              torch.bfloat16)
        out = {"k": kv, "v": kv}
        if cfg.enc_dec:
            out["mem_k"] = out["mem_v"] = (
                (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, hd),
                torch.bfloat16)
        return out
    out = {"ssm": {k: ((cfg.n_layers, *s), torch.float32) for k, s in
                   SSM.decode_state_shapes(cfg, batch).items()}}
    if cfg.is_hybrid:
        kv = ((_n_sites(cfg), batch, max_seq, cfg.n_kv_heads, hd),
              torch.bfloat16)
        out["shared_k"] = out["shared_v"] = kv
    return out


def map_specs(specs: dict, fn) -> dict:
    """``fn(shape, dtype)`` at every leaf of a :func:`cache_specs` tree."""
    return {k: map_specs(v, fn) if isinstance(v, dict) else fn(*v)
            for k, v in specs.items()}


def init_cache(cfg: ModelCfg, batch: int, max_seq: int,
               device=None) -> dict:
    """The zeroed decode cache of :func:`cache_specs` on ``device``
    (default ``cuda``).  An encoder-decoder's ``mem_k`` / ``mem_v`` stay
    zero until :func:`write_cross_memory` fills them, as the reference's
    do until its caller writes them."""
    dev = resolve_device(device)
    return map_specs(cache_specs(cfg, batch, max_seq),
                     lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                   device=dev))


def decode_step(model: LM, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), pos (B,) -> logits
    (B, 1, vocab) and the cache, which is updated in place.

    An SSM layer's state carries each row's history whatever ``pos`` says:
    as in the reference, a row that starts a new sequence at pos 0 keeps
    the previous one's state (``launch.serve_lm`` recycles slots so)."""
    cfg = model.cfg
    cdt = _dtype(cfg.compute_dtype)
    w = model.compute_params()
    h = constrain(embed_lookup(w["embed"], tokens, cdt),
                  ("act_batch", None, "act_embed"))
    if cfg.is_ssm:
        every = _attn_every(cfg)
        for i, p in enumerate(w["ssm_layers"]):
            if every and i % every == 0:
                sp, site = w["shared_attn"], i // every
                hn = rms_norm(h, sp["ln1"], cfg.norm_eps)
                a, _, _ = ATT.attn_decode(sp["attn"], cfg, hn,
                                          cache["shared_k"][site],
                                          cache["shared_v"][site], pos)
                h = _add(h, a)
                # the reference's hybrid decode runs the plain SwiGLU here
                h = _add(h, ffn_apply(sp["ffn"], rms_norm(h, sp["ln2"],
                                                          cfg.norm_eps),
                                      cfg.act_fn))
            state = {k: v[i] for k, v in cache["ssm"].items()}
            y, new = SSM.ssm_decode(p["ssm"], cfg,
                                    rms_norm(h, p["ln"], cfg.norm_eps), state)
            for k, v in new.items():
                state[k].copy_(v)
            h = _add(h, y)
    else:
        for i, (p, window) in enumerate(zip(w.get("dec_layers",
                                                  w.get("layers")),
                                            layer_windows(cfg))):
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            a, _, _ = ATT.attn_decode(p["attn"], cfg, hn, cache["k"][i],
                                      cache["v"][i], pos, window=window)
            h = _add(h, a)
            if cfg.enc_dec:
                # the memory's K and V from the cache, in h's dtype, as the
                # reference reads them
                hn = rms_norm(h, p["ln2"], cfg.norm_eps)
                h = _add(h, ATT.cross_attn_apply(
                    p["xattn"], cfg, hn, cache["mem_k"][i].to(h.dtype),
                    cache["mem_v"][i].to(h.dtype)))
                h = _add(h, ffn_apply(p["ffn"], rms_norm(h, p["ln3"],
                                                         cfg.norm_eps),
                                      cfg.act_fn))
            else:
                h = _add(h, _ffn(p, cfg, rms_norm(h, p["ln2"],
                                                  cfg.norm_eps))[0])
    h = rms_norm(h, w["final_norm"], cfg.norm_eps)
    logits = constrain(lm_logits(w["embed"], h, cdt),
                       ("act_batch", None, "act_vocab"))
    return logits, cache


def write_cross_memory(model: LM, cache: dict, frames: torch.Tensor,
                       rows=None) -> dict:
    """Write the encoder memory of ``frames`` (B, F, D) into an
    encoder-decoder's cache: the encoder (through the flash kernel), then
    each decoder layer's ``cross_memory``, cast to the cache's dtype, into
    ``mem_k`` / ``mem_v`` at the slots ``rows`` (all slots when None; else
    one slot a row of ``frames``).  The caller's side of the reference's
    cache, which nothing in the reference fills; returns the cache,
    written in place."""
    cfg = model.cfg
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.arch_id} has no encoder")
    w = model.compute_params()
    blocks = _serve_blocks(cfg)
    memory = _forward_encoder(cfg, w, frames.to(_dtype(cfg.compute_dtype)),
                              blocks["enc"])
    slots = slice(None) if rows is None else torch.as_tensor(
        rows, device=frames.device)
    for i, p in enumerate(w["dec_layers"]):
        mk, mv = ATT.cross_memory(p["xattn"], cfg, memory)
        cache["mem_k"][i][slots] = mk.to(cache["mem_k"].dtype)
        cache["mem_v"][i][slots] = mv.to(cache["mem_v"].dtype)
    return cache
