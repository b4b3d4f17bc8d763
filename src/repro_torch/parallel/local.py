"""Functions that run on each rank's local shards of DTensors.

The kernels read raw pointers, and some of the model's ops have no
DTensor sharding rule that keeps their operands where the parameter rules
put them (a gather over a sharded vocabulary, a GQA head grouping that a
sharded head axis splits).  Each function here takes DTensors (or plain
tensors, which it passes straight to the plain function), declares the
placements its local computation needs and gives, and runs that
computation through ``torch.distributed.tensor.experimental.local_map``
(which redistributes inputs that arrive otherwise, and carries autograd
through, each input's gradient with the placements it is declared to
have: ``Partial`` where ranks each hold a part of a sum).

On a (1, 1) mesh every shard is the whole tensor and every collective is
over one rank, so each function computes what its plain version does, op
for op.
"""

from __future__ import annotations

import torch

TP_AXIS = "model"


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, made by the model itself (RoPE angles, masks, positions), as
    a replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor;
    ``t`` itself otherwise.  Every rank computes the same ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A small tensor whole on every rank: ``full_tensor()`` of a DTensor
    (an all-gather where it is sharded), ``t`` itself otherwise."""
    return t.full_tensor() if is_dtensor(t) else t


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """``w`` replicated over every mesh dimension but the tensor-parallel
    one: the FSDP all-gather of a weight where a layer uses it (its
    backward reduce-scatters the gradient back to the shards)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    pl = [p if name == TP_AXIS and p.is_shard() else Replicate()
          for name, p in zip(mesh.mesh_dim_names, w.placements)]
    if tuple(pl) == tuple(w.placements):
        return w
    return w.redistribute(mesh, pl)


def _coord(mesh, dim: int) -> int:
    return mesh.get_local_rank(mesh_dim=dim)


def _shard_dim(p) -> int | None:
    return p.dim if p.is_shard() else None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    shard's gradient leaves ``local_map`` as the local part of a DTensor
    gradient, and DTensor's own backward of a reshape views that local
    part as if it were laid out as the whole (an einsum's input gradient,
    a permuted product, is not).  On a one-rank mesh the local part is
    the whole and is left as it is: a copy would change the order in
    which later reductions over it (a norm's backward) sum, and the mesh
    path would no longer give the plain path's bits."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _batch_dims(rows: int, pls, mesh) -> set:
    """The mesh dimensions on which a tensor of ``rows`` rows, placed by
    ``pls``, stays batch-sharded (``Shard(0)``): each while the product of
    their sizes divides ``rows``.  DTensor shards unevenly where it does
    not, and ``local_map`` would then read a rank's share as if it were
    even."""
    out, shards = set(), 1
    for i, p in enumerate(pls):
        if _shard_dim(p) == 0 and rows % (shards * mesh.size(i)) == 0:
            shards *= mesh.size(i)
            out.add(i)
    return out


def _local_map(fn, out_pl, in_pl, grad_pl, mesh):
    from torch.distributed.tensor.experimental import local_map

    def local(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))

    return local_map(local if mesh.size() > 1 else fn,
                     out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)


def head_parallel(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  head_dim: int):
    """``fn(q, k, v)`` (attention: q with Hq heads, k and v with Hkv, the
    heads on dimension ``head_dim``, batch on dimension 0) on each rank's
    heads, its output shaped and placed as q.

    Per mesh dimension q is batch-sharded, head-sharded or replicated (any
    other placement is replicated first); k and v follow q's batch, and
    its heads where Hkv divides the axis.  Where they cannot (the GQA
    fallback: the rules leave 8 kv heads replicated on a 16-way model
    axis while q's 16 heads shard), each rank slices the kv heads its
    own q heads read, by its coordinate: q head ``h`` reads kv head
    ``h // (Hq / Hkv)``, so the local call sees a whole number of groups,
    or one kv head shared by all its q heads, or (neither dividing) one
    kv head gathered per q head; k's and v's gradients are then partial
    sums on that axis.
    """
    if not any_dtensor(q, k, v):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    hq, hkv = q.shape[head_dim], k.shape[head_dim]
    group = hq // hkv
    qp, kp, kgp = [], [], []
    sliced = None                     # (mesh dim, size) where kv is sliced
    qpl = q.placements if is_dtensor(q) else [Replicate()] * mesh.ndim
    batch = _batch_dims(q.shape[0], qpl, mesh)
    for i, p in enumerate(qpl):
        size = mesh.size(i)
        d = _shard_dim(p)
        if i in batch:
            qp.append(Shard(0))
            kp.append(Shard(0))
            kgp.append(Shard(0))
        elif d == head_dim and hq % size == 0:
            qp.append(Shard(head_dim))
            if hkv % size == 0:
                kp.append(Shard(head_dim))
                kgp.append(Shard(head_dim))
            else:
                if sliced is not None:
                    raise ValueError("q's heads shard on two mesh "
                                     "dimensions where k's cannot")
                sliced = (i, size)
                kp.append(Replicate())
                kgp.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgp.append(Replicate())

    def local(ql, kl, vl):
        if sliced is not None:
            i, size = sliced
            n = hq // size
            h0 = _coord(mesh, i) * n
            if n % group == 0:
                idx = slice(h0 // group, (h0 + n) // group)
                kl = kl[(slice(None),) * head_dim + (idx,)]
                vl = vl[(slice(None),) * head_dim + (idx,)]
            else:
                heads = (torch.arange(h0, h0 + n, device=kl.device)
                         // group)
                if group % n == 0:
                    heads = heads[:1]
                kl = kl.index_select(head_dim, heads)
                vl = vl.index_select(head_dim, heads)
        return fn(ql, kl, vl)

    return _local_map(local, qp, (qp, kp, kp), (qp, kgp, kgp), mesh)(
        q, k, v)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", x, w)``: an attention projection, on local
    shards where either is a DTensor.  Per mesh dimension: x batch-sharded
    takes w replicated (w's gradient a partial sum); w head-sharded takes
    x replicated and gives heads (x's gradient a partial sum); else
    replicated.  (DTensor's own einsum flattens the head dimension inside
    the head-dim pair, which it refuses where the heads are sharded.)"""
    if not any_dtensor(x, w):
        return torch.einsum("bsd,dhe->bshe", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ref = x if is_dtensor(x) else w
    mesh = ref.device_mesh
    rep = [Replicate()] * mesh.ndim
    xpl = x.placements if is_dtensor(x) else rep
    wpl = w.placements if is_dtensor(w) else rep
    xp, wp, op, xg, wg = [], [], [], [], []
    batch = _batch_dims(x.shape[0], xpl, mesh)
    for i in range(mesh.ndim):
        if i in batch:
            row = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif _shard_dim(wpl[i]) == 1:
            row = (Replicate(), Shard(1), Shard(2), Partial(), Shard(1))
        else:
            row = (Replicate(),) * 5
        for lst, pl in zip((xp, wp, op, xg, wg), row):
            lst.append(pl)
    return _local_map(lambda a, b: torch.einsum("bsd,dhe->bshe", a, b), op,
                      (xp, wp), (xg, wg), mesh)(replicate_like(x, ref),
                                                replicate_like(w, ref))


def contract_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, w)``: attention's output projection,
    on local shards where either is a DTensor.  Per mesh dimension: o
    batch-sharded takes w replicated (w's gradient a partial sum); o
    head-sharded takes w's heads and gives a partial sum; else
    replicated."""
    if not any_dtensor(o, w):
        return torch.einsum("bshe,hed->bsd", o, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ref = o if is_dtensor(o) else w
    mesh = ref.device_mesh
    rep = [Replicate()] * mesh.ndim
    opl = o.placements if is_dtensor(o) else rep
    op_, wp, out, og, wg = [], [], [], [], []
    batch = _batch_dims(o.shape[0], opl, mesh)
    for i in range(mesh.ndim):
        d = _shard_dim(opl[i])
        if i in batch:
            row = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif d == 2 and o.shape[2] % mesh.size(i) == 0:
            row = (Shard(2), Shard(0), Partial(), Shard(2), Shard(0))
        else:
            row = (Replicate(),) * 5
        for lst, pl in zip((op_, wp, out, og, wg), row):
            lst.append(pl)
    return _local_map(lambda a, b: torch.einsum("bshe,hed->bsd", a, b), out,
                      (op_, wp), (og, wg), mesh)(replicate_like(o, ref),
                                                 replicate_like(w, ref))


def vocab_embed(tok: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``tok[ids]`` with ``tok`` (V, D) vocab-sharded on the model axis
    (the rules' ``embed.tok``) and ``ids`` batch-sharded: each rank looks
    up the ids in its vocab slice and writes zeros elsewhere, a partial
    sum on the model axis (Megatron's vocab-parallel embedding)."""
    if not any_dtensor(tok, ids):
        return tok[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tok.device_mesh
    tp, ip, op, gp = [], [], [], []
    vocab_dim = None
    shards = 1
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, tok.placements)):
        size = mesh.size(i)
        if name == TP_AXIS and p.is_shard() and tok.shape[0] % size == 0:
            tp.append(Shard(0))
            ip.append(Replicate())
            op.append(Partial())
            gp.append(Shard(0))
            vocab_dim = i
        elif ids.shape[0] % (shards * size) == 0:
            shards *= size
            tp.append(Replicate())
            ip.append(Shard(0))
            op.append(Shard(0))
            gp.append(Partial())
        else:
            tp.append(Replicate())
            ip.append(Replicate())
            op.append(Replicate())
            gp.append(Replicate())

    def local(tl, il):
        if vocab_dim is None:
            return tl[il]
        n = tl.shape[0]
        rel = il - _coord(mesh, vocab_dim) * n
        hit = (rel >= 0) & (rel < n)
        rows = tl[rel.clamp(0, n - 1)]
        zero = torch.zeros((), dtype=tl.dtype, device=tl.device)
        return torch.where(hit[..., None], rows, zero)

    return _local_map(local, op, (tp, ip), (gp, ip), mesh)(tok, ids)


def vocab_gather(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits.gather(-1, labels[..., None])[..., 0]`` with ``logits``
    (B, S, V) vocab-sharded on the model axis: each rank gathers the
    labels in its slice, zeros elsewhere, a partial sum on that axis."""
    if not any_dtensor(logits, labels):
        return logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    lp, ip, op, gp = [], [], [], []
    vocab_dim = None
    batch = _batch_dims(logits.shape[0], logits.placements, mesh)
    for i, p in enumerate(logits.placements):
        d = _shard_dim(p)
        if i in batch:
            lp.append(Shard(0))
            ip.append(Shard(0))
            op.append(Shard(0))
            gp.append(Shard(0))
        elif d == last and vocab_dim is None:
            lp.append(Shard(last))
            ip.append(Replicate())
            op.append(Partial())
            gp.append(Shard(last))
            vocab_dim = i
        else:
            lp.append(Replicate())
            ip.append(Replicate())
            op.append(Replicate())
            gp.append(Replicate())

    def local(ll, il):
        if vocab_dim is None:
            return ll.gather(-1, il[..., None])[..., 0]
        n = ll.shape[-1]
        rel = il - _coord(mesh, vocab_dim) * n
        hit = (rel >= 0) & (rel < n)
        got = ll.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros((), dtype=ll.dtype,
                                                 device=ll.device))

    return _local_map(local, op, (lp, ip), (gp, ip), mesh)(logits, labels)


def matmul_placements(xp, wp, mesh, transposed: bool = False,
                      rows: int | None = None):
    """Placements of a product ``x (M, K) @ w (K, N)`` (``w`` (N, K) with
    ``transposed``) computed on local shards: ``(x's, w's, out's, x's
    gradient's, w's gradient's)``, one entry a mesh dimension.

    Per mesh dimension: x batch-sharded (rows) takes w replicated (the
    FSDP gather where w arrives sharded) and gives rows, w's gradient a
    partial sum; w column-sharded (N) takes x replicated and gives
    columns, x's gradient partial; w row-sharded (K) takes x
    column-sharded and gives a partial sum; else all replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    k_dim, n_dim = (1, 0) if transposed else (0, 1)
    out = ([], [], [], [], [])
    batch = (_batch_dims(rows, xp, mesh) if rows is not None else
             {i for i, p in enumerate(xp) if _shard_dim(p) == 0})
    for i in range(mesh.ndim):
        px, pw = _shard_dim(xp[i]), _shard_dim(wp[i])
        if i in batch:
            row = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif pw == n_dim:
            row = (Replicate(), Shard(n_dim), Shard(1), Partial(),
                   Shard(n_dim))
        elif pw == k_dim:
            row = (Shard(1), Shard(k_dim), Partial(), Shard(1),
                   Shard(k_dim))
        else:
            row = (Replicate(),) * 5
        for lst, p in zip(out, row):
            lst.append(p)
    return out


def matmul_shards(fn, x, w, mask, b=None, transposed: bool = False):
    """``fn(x, w, mask[, b])`` (a masked product, ``x @ (w * mask) + b``)
    on local shards, by :func:`matmul_placements`; ``mask`` is placed as
    ``w``, ``b`` (N,) as w's columns.  A bias with a row-sharded w (whose
    output is a partial sum) raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = next(t for t in (x, w, mask) if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    xp = x.placements if is_dtensor(x) else rep
    wp = w.placements if is_dtensor(w) else rep
    xin, win, outp, xg, wg = matmul_placements(xp, wp, mesh, transposed,
                                               x.shape[0])
    n_dim = 0 if transposed else 1
    ins, grads = [xin, win, win], [xg, wg, wg]
    args = [x, w, mask]
    if b is not None:
        if any(p.is_partial() for p in outp):
            raise ValueError("a bias on a product whose K is sharded")
        bp = [Shard(0) if p.is_shard() and p.dim == n_dim else Replicate()
              for p in win]
        ins.append(bp)
        grads.append(bp)
        args.append(b)
    args = [replicate_like(t, x if is_dtensor(x) else w) for t in args]
    return _local_map(fn, outp, tuple(ins), tuple(grads), mesh)(*args)


def data_parallel(fn, x: torch.Tensor, params: dict, *extra,
                  n_out: int = 1, shards_ok=None):
    """``fn(x, params, *extra)`` with ``x`` and ``extra`` (batch first)
    batch-sharded over the mesh dimensions but the tensor-parallel one
    (each while the batch divides, and ``shards_ok(n)``, if given, holds
    for the number of batch shards ``n``) and ``params`` (a flat dict)
    replicated: a block whose work is independent a sequence (an SSM's
    scan, a MoE's dispatch of its token groups) on each rank's sequences,
    its weights whole.  Returns ``fn``'s output (``n_out`` tensors, batch
    first) placed as x; the weights' gradients are partial sums over the
    batch axes."""
    if not any_dtensor(x, *params.values(), *extra):
        return fn(x, params, *extra)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ref = next(t for t in (x, *params.values(), *extra) if is_dtensor(t))
    mesh = ref.device_mesh
    xp, wg = [], []
    shards = 1
    for i in range(mesh.ndim):
        n = shards * mesh.size(i)
        if (mesh.mesh_dim_names[i] != TP_AXIS and x.shape[0] % n == 0
                and (shards_ok is None or shards_ok(n))):
            shards = n
            xp.append(Shard(0))
            wg.append(Partial())
        else:
            xp.append(Replicate())
            wg.append(Replicate())
    rep = [Replicate()] * mesh.ndim
    names = list(params)

    def local(xl, *rest):
        p = dict(zip(names, rest[:len(names)]))
        return fn(xl, p, *rest[len(names):])

    outp = xp if n_out == 1 else tuple([xp] * n_out)
    ins = (xp,) + (rep,) * len(names) + (xp,) * len(extra)
    grads = (xp,) + (wg,) * len(names) + (xp,) * len(extra)
    args = [replicate_like(t, ref) for t in (x, *params.values(), *extra)]
    return _local_map(local, outp, ins, grads, mesh)(*args)
