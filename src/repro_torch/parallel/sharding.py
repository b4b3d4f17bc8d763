"""Sharding rules: parameter-name regexes -> specs, shape-validated, and
their DTensor placements.

The port of ``repro.parallel.sharding``.  Policy tokens per tensor
dimension:
  'fsdp' -> the data(-and-pod) axes: ZeRO-3 style weight sharding; the
            model gathers a layer's weights where it uses them
            (``parallel.local.gather_fsdp``) and their gradients come back
            reduce-scattered.
  'tp'   -> the model axis: tensor/expert parallelism.
  None   -> replicated.

Rules are *candidates*: at resolution each dim's axes are dropped unless
the dim is divisible by the axis product (e.g. 4 KV heads cannot shard a
16-way model axis -> replicated, the standard GQA fallback).  This is what
lets one rule set serve 10 architectures x arbitrary meshes.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dimension, each ``None``, an axis name or a tuple of axis names
(``()`` replicates everything).  Resolution reads only the mesh's axis
sizes, so ``mesh`` is a ``DeviceMesh`` or anything whose ``.shape`` maps
axis names to sizes.  :func:`placements` turns a spec into one DTensor
placement a mesh dimension; :func:`distribute` lays a tree of tensors out
on a mesh.

Names are the port's dotted parameter names (``layers.3.attn.wq``, the
train state's ``params.layers.3.attn.wq`` and ``opt.m.layers.3.attn.wq``);
:func:`reference_path` turns them into the reference's keystr
(``['layers']['attn']['wq']``: the layer index dropped) so that the
reference's regexes match them as they stand.  Tokens right-align to the
shape, so a per-layer leaf gets the reference's stacked leaf's spec
without its leading layer entry.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Maps rule tokens to mesh axes."""

    fsdp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)
    # 'fsdp_tp' shards weights over both; 'tp_only' replicates over data
    # (pure TP — a §Perf comparison point).
    mode: str = "fsdp_tp"

    def axes_for(self, token) -> tuple[str, ...] | None:
        if token is None:
            return None
        if token == "tp":
            return self.tp
        if token == "fsdp":
            return None if self.mode == "tp_only" else self.fsdp
        if token == "dp":
            return self.fsdp
        raise ValueError(token)


def multi_pod_policy(mode: str = "fsdp_tp") -> ShardingPolicy:
    return ShardingPolicy(fsdp=("pod", "data"), tp=("model",), mode=mode)


# (path regex, per-dim tokens), on the reference's keystr.  Stacked layer
# params carry a leading layer dim (always None).  First match wins.
PARAM_RULES: list[tuple[str, tuple | None]] = [
    # embeddings: vocab over tp (sharded logits), d_model over fsdp
    (r"\['embed'\]\['(tok|head)'\]$", ("tp", "fsdp")),
    (r"\['pos_emb_enc'\]$", (None, "fsdp")),
    # attention
    (r"\['attn'\]\['wq'\]$", (None, "fsdp", "tp", None)),
    (r"\['attn'\]\['w[kv]'\]$", (None, "fsdp", "tp", None)),
    (r"\['attn'\]\['wo'\]$", (None, "tp", None, "fsdp")),
    (r"\['(xattn)'\]\['wq'\]$", (None, "fsdp", "tp", None)),
    (r"\['(xattn)'\]\['w[kv]'\]$", (None, "fsdp", "tp", None)),
    (r"\['(xattn)'\]\['wo'\]$", (None, "tp", None, "fsdp")),
    (r"\['(q_norm|k_norm)'\]$", None),                     # tiny: replicate
    # dense FFN (LogicNet-FFN masks shard like their weights)
    (r"\['ffn'\]\['wi_(gate|up)'\]$", (None, "fsdp", "tp")),
    (r"\['ffn'\]\['mask_in'\]$", (None, "fsdp", "tp")),
    (r"\['ffn'\]\['wo'\]$", (None, "tp", "fsdp")),
    (r"\['ffn'\]\['mask_out'\]$", (None, "tp", "fsdp")),
    # MoE: experts over tp (EP), d_model over fsdp
    (r"\['moe'\]\['router'\]$", (None, "fsdp", None)),
    (r"\['moe'\]\['wi_(gate|up)'\]$", (None, "tp", "fsdp", None)),
    (r"\['moe'\]\['wo'\]$", (None, "tp", None, "fsdp")),
    # SSM
    (r"\['ssm'\]\['in_proj'\]$", (None, "fsdp", "tp")),
    (r"\['ssm'\]\['conv_w'\]$", (None, None, "tp")),
    (r"\['ssm'\]\['conv_b'\]$", (None, "tp")),
    (r"\['ssm'\]\['out_proj'\]$", (None, "tp", "fsdp")),
    (r"\['ssm'\]\['(a_log|d_skip|dt_bias|norm)'\]$", None),
    # shared (unstacked) hybrid attention block: same but no layer dim
    (r"\['shared_attn'\].*\['wq'\]$", ("fsdp", "tp", None)),
    (r"\['shared_attn'\].*\['w[kv]'\]$", ("fsdp", "tp", None)),
    (r"\['shared_attn'\].*\['wo'\]$", ("tp", None, "fsdp")),
    (r"\['shared_attn'\]\['ffn'\]\['wi_(gate|up)'\]$", ("fsdp", "tp")),
    (r"\['shared_attn'\]\['ffn'\]\['wo'\]$", ("tp", "fsdp")),
    # norms and anything small: replicated
    (r".*", None),
]


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object whose
    ``.shape`` maps axis names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _mesh_axis_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def resolve_spec(shape: tuple[int, ...], tokens, policy: ShardingPolicy,
                 mesh) -> tuple:
    """Validated spec: drop axes that don't divide the dim."""
    if tokens is None:
        return ()
    # Right-align tokens to the shape (stacked layer params gained a
    # leading layer axis relative to the per-layer rule).
    tokens = tuple(tokens)
    if len(tokens) < len(shape):
        tokens = (None,) * (len(shape) - len(tokens)) + tokens
    elif len(tokens) > len(shape):
        tokens = tokens[-len(shape):] if shape else ()
    spec = []
    for dim, tok in zip(shape, tokens):
        axes = policy.axes_for(tok)
        if axes is None or dim % _mesh_axis_size(mesh, axes) != 0:
            spec.append(None)
        else:
            spec.append(axes if len(axes) > 1 else axes[0])
    return tuple(spec)


def reference_path(name: str) -> str:
    """The reference's keystr of the port's dotted name: every part that
    is not a layer index in ``['...']`` (``layers.3.attn.wq`` ->
    ``['layers']['attn']['wq']``)."""
    return "".join(f"['{p}']" for p in name.split(".") if not p.isdigit())


def spec_for_path(path: str, shape: tuple[int, ...],
                  policy: ShardingPolicy, mesh) -> tuple:
    """The spec of the leaf at ``path``: a dotted port name or a
    reference keystr."""
    if not path.startswith("["):
        path = reference_path(path)
    for pattern, tokens in PARAM_RULES:
        if re.search(pattern, path):
            return resolve_spec(shape, tokens, policy, mesh)
    return ()


def placements(spec: tuple, mesh) -> list:
    """One DTensor placement a dimension of ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` where tensor dim ``d``'s spec entry names the axis (an
    entry over two axes, ``("pod", "data")``, shards ``d`` on both),
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def named_leaves(tree: Any, prefix: str = ""):
    """``(dotted name, leaf)`` of a nested dict / list tree of tensors (or
    of anything with ``.shape``), in its order."""
    if not isinstance(tree, (dict, list, tuple)):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, sub in items:
        yield from named_leaves(sub, f"{prefix}.{key}" if prefix
                                else str(key))


def tree_specs(tree: Any, mesh, policy: ShardingPolicy) -> dict:
    """``{dotted name: spec}`` of every leaf of a parameter / state
    tree."""
    return {name: spec_for_path(name, tuple(leaf.shape), policy, mesh)
            for name, leaf in named_leaves(tree)}


def shardings_for_tree(tree: Any, mesh, policy: ShardingPolicy) -> dict:
    """``{dotted name: placements}`` of every leaf of a parameter / state
    tree on the ``DeviceMesh`` ``mesh``."""
    return {name: placements(spec, mesh)
            for name, spec in tree_specs(tree, mesh, policy).items()}


def _rebuild(tree: Any, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}.{i}" if prefix
                                   else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def local_shard(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's shard of ``t`` under placements ``pl``, cut from ``t``
    (which every rank holds whole) mesh dimension by mesh dimension, as
    DTensor orders shards, and made contiguous: a copy of the shard alone,
    or ``t`` itself, its storage shared, where the shard is the whole (a
    one-rank mesh moves a state onto the mesh without a copy).  A
    dimension that its mesh dimensions do not divide raises (the rules
    never shard one)."""
    for i, p in enumerate(pl):
        if p.is_shard():
            n, d = mesh.size(i), p.dim % t.dim()
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {n} ranks")
            size = t.shape[d] // n
            t = t.narrow(d, mesh.get_local_rank(mesh_dim=i) * size, size)
    return t.contiguous()


def distribute_leaf(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``t`` laid out on ``mesh`` with placements ``pl``: a DTensor that
    requires grad when ``t`` does (a leaf of its own).  Each rank keeps
    its :func:`local_shard` of ``t``, which every rank holds whole (a
    seeded init, a checkpoint's arrays); a ``meta`` tensor gives a
    ``meta`` DTensor."""
    from torch.distributed.tensor import DTensor
    grad, t = t.requires_grad, t.detach()
    if isinstance(t, DTensor):
        out = t.redistribute(mesh, pl)
    else:
        out = DTensor.from_local(local_shard(t, mesh, pl), mesh, pl,
                                 run_check=False)
    return out.requires_grad_(grad)


def distribute_by_specs(tree: Any, specs: dict, mesh) -> Any:
    """``tree`` (nested dicts / lists of tensors) with each leaf laid out
    by its spec in ``specs`` (``{dotted name: spec}``), as
    :func:`distribute` does with the parameter rules."""
    return _rebuild(tree, lambda name, t: distribute_leaf(
        t, mesh, placements(specs[name], mesh)))


def distribute(tree: Any, mesh, policy: ShardingPolicy) -> Any:
    """A state or a model's parameters on the mesh: every leaf of the
    nested tree a DTensor with the placements of its rule."""
    return distribute_by_specs(tree, tree_specs(tree, mesh, policy), mesh)


# ---------------------------------------------------------------------------
# Batch / cache / activation shardings
# ---------------------------------------------------------------------------

def batch_specs(policy: ShardingPolicy, mesh, batch_shapes: Any) -> dict:
    """Inputs: leading batch dim over dp axes (dropped if not divisible);
    ``{dotted name: spec}``."""
    out = {}
    for name, leaf in named_leaves(batch_shapes):
        dims = len(leaf.shape)
        tokens = ("dp",) + (None,) * (dims - 1)
        out[name] = resolve_spec(tuple(leaf.shape), tokens, policy, mesh)
    return out


def cache_specs(policy: ShardingPolicy, mesh, cache_shapes: Any,
                cache_shard: str = "heads") -> dict:
    """KV/SSM caches (``models.model.cache_specs``' tree: ``k``, ``v``
    (L, B, S, Hkv, hd), ``mem_k`` / ``mem_v``, ``shared_k`` /
    ``shared_v``, ``ssm.ssd`` (L, B, H, P, N) and ``ssm.conv`` (L, B, W,
    C)); ``{dotted name: spec}``.

    cache_shard='heads' (baseline): batch over dp, kv-heads over tp (with
    the GQA divisibility fallback -> replicated when kv_heads < tp size).
    cache_shard='seq': shard the sequence dim over tp instead.
    Batch-1 long-decode cells (batch not divisible by dp) always fall back
    to seq sharding.
    """
    out = {}
    for name, leaf in named_leaves(cache_shapes):
        shape = tuple(leaf.shape)
        dims = len(shape)
        if "ssm" in name:
            # (L, B, H, P, N) state / (L, B, W, C) conv: heads/channels tp
            tokens = (None, "dp") + (("tp",) + (None,) * (dims - 3)
                                     if dims >= 3 else ())
        else:
            # (L/sites, B, S, Hkv, hd)
            tokens = [None, "dp", None, "tp", None][:dims]
            dp_size = _mesh_axis_size(mesh, policy.fsdp)
            if cache_shard == "seq" or shape[1] % dp_size != 0:
                tokens[2] = "tp"
                tokens[3] = None
            tokens = tuple(tokens)
        out[name] = resolve_spec(shape, tokens, policy, mesh)
    return out


def activation_rules(policy: ShardingPolicy) -> dict[str, Any]:
    """Logical activation axis names -> mesh axes (parallel.ctx rules)."""
    fsdp = policy.fsdp
    return {
        "act_batch": fsdp if len(fsdp) > 1 else fsdp[0],
        "act_embed": None,
        "act_vocab": policy.tp[0] if len(policy.tp) == 1 else policy.tp,
        "act_heads": policy.tp[0] if len(policy.tp) == 1 else policy.tp,
    }
