"""Activation-sharding context.

The port of ``repro.parallel.ctx``.  Model code annotates activations
with *logical* axis names (``constrain(x, ("act_batch", None,
"act_vocab"))``); the launch layer activates a mesh + rule set that maps
logical names to mesh axes.  With no active context, or on a tensor that
is not a DTensor, the calls are no-ops, so the same model code runs
single-device and on a mesh unchanged.  Inside one, ``constrain``
redistributes a DTensor to the placements the names give (the
reference's ``with_sharding_constraint``): a name that maps to no axis
replicates, as ``P(None)`` does, and so does an axis whose size does not
divide the dimension (DTensor would shard it unevenly).  The gradient
is constrained to the same placements (:class:`_Constrain`).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.parallel.sharding import axis_sizes

_STATE = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict[str, tuple | str | None]):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current() -> tuple | None:
    return getattr(_STATE, "ctx", None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    ctx = current()
    if ctx is None or not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, rules = ctx
    sizes = axis_sizes(mesh)
    pl = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, name in enumerate(logical):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        size = 1
        for a in axes:
            size *= sizes[a]
        if x.shape[dim] % size:
            continue
        for a in axes:
            pl[names.index(a)] = Shard(dim)
    if tuple(x.placements) == tuple(pl) and not x.requires_grad:
        return x
    return _Constrain.apply(x, mesh, tuple(pl))


class _Constrain(torch.autograd.Function):
    """``x.redistribute(mesh, pl)`` whose gradient is redistributed to
    ``pl`` too, as XLA's sharding constraint binds the cotangent: a
    gradient that arrives as a partial sum (the vocab-sharded head's,
    flowing down the residual stream) is reduced here, where the
    reference's layout says the activation is replicated, and the
    products below it see it so."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.pl), None, None
