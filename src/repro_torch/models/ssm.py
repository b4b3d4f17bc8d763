"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060.

The port's counterpart of ``repro.models.ssm``: ``_dims``, ``ssm_init``,
``_split_proj``, ``_causal_conv``, ``_segsum``, ``ssd_chunked``,
``ssm_apply``, ``ssm_decode_state`` and ``ssm_decode``.  Prefill runs the
chunked SSD algorithm (quadratic inside chunks of ``cfg.ssm.chunk``
tokens, a state passed between chunks by a loop in place of the
reference's ``lax.scan``); decode is the one-token recurrence on the
(H, P, N) state.  The reference computes both as XLA einsums outside any
Pallas kernel; here they are torch products, each einsum of more than
two operands written as two-operand steps (``torch.einsum`` optimises no
contraction path), which also fixes the largest intermediate at one
(B, NC, H, L, L) float32 block.

Points of rounding follow the reference: the scan runs in float32 on
inputs in the compute dtype, its output returns to it; ``dt`` is
``softplus`` as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``,
never the identity above a threshold); decode keeps its conv ring and
state in float32 and rounds ``y`` to the compute dtype before the gate.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import init_rms, normal_init, rms_norm
from repro_torch.obs.trace import span
from repro_torch.parallel.local import data_parallel


def _dims(cfg: ModelCfg):
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    n_heads = d_in // ssm.head_dim
    conv_dim = d_in + 2 * ssm.n_groups * ssm.d_state
    return d_in, n_heads, conv_dim


def ssm_init(gen: torch.Generator, cfg: ModelCfg, dtype) -> dict:
    """``in_proj`` normal x 1/sqrt(d), ``conv_w`` normal x 0.2, ``conv_b``
    0, ``a_log`` log(linspace(1, 16, H)), ``d_skip`` 1, ``dt_bias`` 0,
    ``norm`` 0 and ``out_proj`` normal x 1/sqrt(d_in), as the reference's
    ``ssm_init``."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, conv_dim = _dims(cfg)
    proj_dim = 2 * d_in + 2 * ssm.n_groups * ssm.d_state + n_heads
    dev = gen.device
    return {
        "in_proj": normal_init((d, proj_dim), 1.0 / d ** 0.5, gen, dtype),
        "conv_w": normal_init((ssm.conv_width, conv_dim), 0.2, gen, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm": init_rms(d_in, dev),
        "out_proj": normal_init((d_in, d), 1.0 / d_in ** 0.5, gen, dtype),
    }


def _split_proj(cfg: ModelCfg, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) of the input projection."""
    d_in, n_heads, _ = _dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, n_heads], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU; x (B, S, C), w (W, C),
    in x's dtype, a tap at a time as the reference sums them."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular segment sums, ``-inf``
    above the diagonal: S[i, j] = sum_{j < k <= i} a_k."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD scan (mamba2 Algorithm 1, chunked).

    x: (B, S, H, P) pre-scaled by dt; a: (B, S, H) = dt * A (negative);
    b, c: (B, S, G, N), head h in group h // (H / G).  Returns (y in x's
    dtype, final state (B, H, P, N) float32).
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g
    xf = x.float().reshape(bs, nc, chunk, h, p)
    af = a.float().reshape(bs, nc, chunk, h).transpose(2, 3)  # (B,NC,H,L)
    bf = b.float().reshape(bs, nc, chunk, g, n)
    cf = c.float().reshape(bs, nc, chunk, g, n)

    a_cs = torch.cumsum(af, dim=-1)                           # (B,NC,H,L)
    # 1. intra-chunk: "bclhn,bcshn,bhcls,bcshp->bclhp" as C B^T per group
    # (the heads of a group share it), times the decay, times x
    ll = torch.exp(_segsum(af)).reshape(bs, nc, g, rep, chunk, chunk)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cf, bf)           # (B,NC,G,L,L)
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", cb[:, :, :, None] * ll,
                          xf.reshape(bs, nc, chunk, g, rep, p))
    del ll, cb
    # 2. per-chunk end states: "bclhn,bhcl,bclhp->bchpn" as the decay times
    # x, then the product with B over the chunk
    decay = torch.exp(a_cs[..., -1:] - a_cs).transpose(2, 3)  # (B,NC,L,H)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", bf,
                          (xf * decay[..., None]).reshape(
                              bs, nc, chunk, g, rep, p)).reshape(
                                  bs, nc, h, p, n)
    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cs[..., -1])                    # (B,NC,H)
    carry = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # (B,NC,H,P,N)
    # 4. state -> output within the chunk: "bclhn,bchpn,bhcl->bclhp" as C
    # times the entering state, times the decay from the chunk's start
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", cf, prev_states.reshape(
        bs, nc, g, rep, p, n)).reshape(bs, nc, chunk, h, p)
    y_off = y_off * torch.exp(a_cs).transpose(2, 3)[..., None]
    y = (y_diag.reshape(bs, nc, chunk, h, p) + y_off).reshape(bs, s, h, p)
    return y.to(x.dtype), carry


def gated_norm(cfg: ModelCfg, y: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The RMSNorm of the gated output ``y`` (..., d_in): over all of
    d_in, or with ``cfg.ssm.grouped_norm`` over each of its ``n_groups``
    groups of d_in / n_groups channels (Zamba2's), ``scale`` read in the
    same groups."""
    groups = cfg.ssm.n_groups if cfg.ssm.grouped_norm else 1
    if groups == 1:
        return rms_norm(y, scale, cfg.norm_eps)
    shape = y.shape
    return rms_norm(y.reshape(*shape[:-1], groups, -1),
                    scale.reshape(groups, -1), cfg.norm_eps).reshape(shape)


def ssm_apply(p: dict, cfg: ModelCfg, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block; u: (B, S, D).  On a mesh (DTensor
    weights) each rank scans its own sequences (``parallel.local.
    data_parallel``) and, where the model axis divides the heads, only
    its own heads (:func:`head_parallel_plan`): its output is then a
    partial sum over that axis.  Elsewhere the block's weights are
    gathered whole.  The chunked scan is the step span ``ssd``."""
    plan = head_parallel_plan(cfg, p)
    if plan is None:
        return data_parallel(lambda x, w: _ssm_apply(w, cfg, x), u, p)
    from torch.distributed.tensor import Partial
    return data_parallel(lambda x, w: _ssm_apply_heads(w, cfg, x, plan),
                         u, p, tp=plan.placements(p), tp_out=Partial())


def _ssm_apply(p: dict, cfg: ModelCfg, u: torch.Tensor) -> torch.Tensor:
    z, x, b, c, dt = _split_proj(cfg, u @ p["in_proj"])
    return _ssm_scan(p, cfg, z, x, b, c, dt, p["conv_w"], p["conv_b"],
                     lambda y: gated_norm(cfg, y, p["norm"]))


def _ssm_scan(p: dict, cfg: ModelCfg, z, x, b, c, dt, conv_w, conv_b,
              norm) -> torch.Tensor:
    """The block from its projection's pieces on: the conv, the chunked
    scan, the gate, ``norm`` and ``out_proj``; the heads, groups and
    widths read off the pieces (a rank's share of them on a mesh)."""
    ssm = cfg.ssm
    d_in, gn, n_heads = x.shape[-1], b.shape[-1], dt.shape[-1]
    groups = gn // ssm.d_state
    xbc = _causal_conv(torch.cat([x, b, c], dim=-1), conv_w, conv_b)
    x, b, c = torch.split(xbc, [d_in, gn, gn], dim=-1)
    bs, s, _ = x.shape
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,S,H)
    xh = x.reshape(bs, s, n_heads, ssm.head_dim)
    a = -torch.exp(p["a_log"])[None, None, :] * dt            # (B,S,H)
    bg = b.reshape(bs, s, groups, ssm.d_state)
    cg = c.reshape(bs, s, groups, ssm.d_state)
    with span("ssd"):
        y, _ = ssd_chunked(xh * dt[..., None].to(xh.dtype), a, bg, cg,
                           min(ssm.chunk, s))
    y = y + xh * p["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(bs, s, d_in) * F.silu(z)
    return norm(y) @ p["out_proj"]


def _heads(cfg: ModelCfg, size: int, r: int) -> tuple[int, int, int, int]:
    """``(h0, h1, g0, g1)``: the heads and groups of rank ``r`` of a model
    axis of ``size`` ranks."""
    _, n_heads, _ = _dims(cfg)
    n, rep = n_heads // size, n_heads // cfg.ssm.n_groups
    h0 = r * n
    return h0, h0 + n, h0 // rep, (h0 + n - 1) // rep + 1


def _proj_cols(cfg: ModelCfg, size: int, r: int, whole_xbc: bool) -> list:
    """The columns of the packed ``[z | x | B | C | dt]`` projection rank
    ``r`` reads (``x``, ``B`` and ``C`` whole with ``whole_xbc``: the
    decode's conv ring keeps every channel)."""
    d_in, _, _ = _dims(cfg)
    hd, ns = cfg.ssm.head_dim, cfg.ssm.d_state
    gn = cfg.ssm.n_groups * ns
    h0, h1, g0, g1 = _heads(cfg, size, r)
    if whole_xbc:
        xbc = range(d_in, 2 * d_in + 2 * gn)
    else:
        xbc = [*range(d_in + h0 * hd, d_in + h1 * hd),
               *range(2 * d_in + g0 * ns, 2 * d_in + g1 * ns),
               *range(2 * d_in + gn + g0 * ns, 2 * d_in + gn + g1 * ns)]
    return [*range(h0 * hd, h1 * hd), *xbc,
            *range(2 * d_in + 2 * gn + h0, 2 * d_in + 2 * gn + h1)]


def _conv_cols(cfg: ModelCfg, size: int, r: int) -> list:
    """The channels of the packed ``[x | B | C]`` conv rank ``r`` reads."""
    d_in, _, _ = _dims(cfg)
    hd, ns = cfg.ssm.head_dim, cfg.ssm.d_state
    gn = cfg.ssm.n_groups * ns
    h0, h1, g0, g1 = _heads(cfg, size, r)
    return [*range(h0 * hd, h1 * hd),
            *range(d_in + g0 * ns, d_in + g1 * ns),
            *range(d_in + gn + g0 * ns, d_in + gn + g1 * ns)]


@functools.lru_cache(maxsize=64)
def _regroups(cfg: ModelCfg, size: int, rank: int, whole_xbc: bool):
    """Rank ``rank``'s ``parallel.local.Regroup`` of the packed
    projection's columns and of the conv's channels, on a model axis of
    ``size`` ranks: built once a layout, not once a call."""
    from repro_torch.parallel.local import Regroup
    d_in, n_heads, conv_dim = _dims(cfg)
    proj = Regroup(conv_dim + d_in + n_heads,
                   [_proj_cols(cfg, size, q, whole_xbc)
                    for q in range(size)], rank)
    conv = Regroup(conv_dim, [_conv_cols(cfg, size, q)
                              for q in range(size)], rank)
    return proj, conv


class HeadPlan:
    """A model rank's share of an SSM block, heads ``h0`` to ``h1`` of
    ``n_heads`` and their groups ``g0`` to ``g1`` (one group of B and C,
    replicated, where ``n_groups`` is 1), on a model axis of ``size``
    ranks (``parallel.local.tp_group``'s triple ``tp``): the packed
    columns and conv channels it reads, and the placements of the
    block's weights on that axis (their own: ``in_proj`` and ``conv_w``
    columns, ``conv_b`` entries, ``out_proj`` rows, each split evenly or
    whole; the per-head vectors and the norm whole, each rank reading its
    slice)."""

    def __init__(self, cfg: ModelCfg, tp: tuple):
        self.cfg, self.tp = cfg, tp
        self.rank, self.size = tp[0], tp[1]

    def placements(self, p: dict) -> list:
        """The model-axis placements of the block's weights: their own."""
        from repro_torch.parallel.local import tp_placement
        return [tp_placement(w) for w in p.values()]

    def local(self, p: dict, u: torch.Tensor, whole_xbc: bool = False):
        """This rank's ``(z, x, B, C, dt)`` of ``u``'s projection, its
        conv weight and bias, and ``p`` with its per-head vectors, norm
        slice and ``out_proj`` rows.  The packed weights shard evenly,
        not at head boundaries (mamba2-370m's 4384 columns give 274 a
        rank at 16): a rank's pieces come by one all-to-all
        (``parallel.local.Regroup``) of the weight's columns or of the
        projected activation, as :meth:`regroups_weight` picks."""
        cfg, group = self.cfg, self.tp[2]
        d_in, _, _ = _dims(cfg)
        hd, ns = cfg.ssm.head_dim, cfg.ssm.d_state
        proj_cols, conv_ch = _regroups(cfg, self.size, self.rank, whole_xbc)
        proj = p["in_proj"]
        if self.regroups_weight(u):
            zxbcdt = u @ proj_cols(proj, 1, group)
        else:
            zxbcdt = proj_cols(u @ proj, -1, group)
        h0, h1, g0, g1 = _heads(cfg, self.size, self.rank)
        nx = d_in if whole_xbc else (h1 - h0) * hd
        gl = cfg.ssm.n_groups * ns if whole_xbc else (g1 - g0) * ns
        z, x, b, c, dt = torch.split(
            zxbcdt, [(h1 - h0) * hd, nx, gl, gl, h1 - h0], dim=-1)
        conv_w = conv_ch(p["conv_w"], 1, group)
        conv_b = conv_ch(p["conv_b"], 0, group)
        heads = slice(h0, h1)
        lp = {k: p[k][heads] for k in ("a_log", "d_skip", "dt_bias")}
        lp["norm"] = p["norm"][h0 * hd:h1 * hd]
        out = p["out_proj"]
        lp["out_proj"] = out if out.shape[0] == (h1 - h0) * hd else \
            out[h0 * hd:h1 * hd]
        return (z, x, b, c, dt), conv_w, conv_b, lp

    @staticmethod
    def regroups_weight(u: torch.Tensor) -> bool:
        """Whether a rank regroups ``in_proj``'s columns (``d_model`` rows)
        rather than the projected activation (a row a token): where its
        tokens are at least ``d_model`` (prefill, training), the one with
        fewer rows, so fewer bytes (``tools/ssm_regroup_routes.py`` reads
        both in the dry-run)."""
        return u.shape[0] * u.shape[1] >= u.shape[-1]

    def channels(self, hist: torch.Tensor) -> torch.Tensor:
        """This rank's conv channels of ``hist`` (..., conv_dim), which
        holds every channel."""
        return _regroups(self.cfg, self.size, self.rank, True)[1](
            hist, -1, self.tp[2])

    def norm(self, y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """The gated ``rms_norm`` over the whole ``d_in`` on a rank's share
        of it: its share of the mean of squares, summed over the model
        axis (``parallel.local.tp_sum``); on one rank ``rms_norm`` as it
        is."""
        from repro_torch.parallel.local import tp_sum
        if self.size == 1:
            return rms_norm(y, scale, self.cfg.norm_eps)
        d_in, _, _ = _dims(self.cfg)
        share = y.shape[-1] / d_in
        return rms_norm(y, scale, self.cfg.norm_eps,
                        mean_sq=lambda v: tp_sum(v * share, self.tp))


def head_parallel_plan(cfg: ModelCfg, p: dict) -> HeadPlan | None:
    """The block's :class:`HeadPlan` on a mesh whose model axis divides
    the heads and whose heads a rank holds are whole groups or within
    one group; None off a mesh and where it does not (the block then
    runs on each rank's sequences with its weights whole, as
    ``resolve_spec`` replicates a dimension the axis does not divide)."""
    from repro_torch.parallel.local import any_dtensor, tp_group
    if not any_dtensor(*p.values()):
        return None
    tp = tp_group(p["in_proj"])
    _, n_heads, _ = _dims(cfg)
    per, rep = n_heads // tp[1], n_heads // cfg.ssm.n_groups
    if tp[2] is None or n_heads % tp[1] or (per % rep and rep % per):
        return None
    if cfg.ssm.grouped_norm:
        raise NotImplementedError("the grouped gated norm runs on one "
                                  "device only, not head-parallel")
    return HeadPlan(cfg, tp)


def _ssm_apply_heads(p: dict, cfg: ModelCfg, u: torch.Tensor,
                     plan: HeadPlan) -> torch.Tensor:
    (z, x, b, c, dt), conv_w, conv_b, lp = plan.local(p, u)
    return _ssm_scan(lp, cfg, z, x, b, c, dt, conv_w, conv_b,
                     lambda y: plan.norm(y, lp["norm"]))


# ---------------------------------------------------------------------------
# Decode: O(1) state recurrence
# ---------------------------------------------------------------------------

def decode_state_shapes(cfg: ModelCfg, batch: int) -> dict:
    """``{"ssd": shape, "conv": shape}`` of one layer's float32 decode
    state."""
    ssm = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return {"ssd": (batch, n_heads, ssm.head_dim, ssm.d_state),
            "conv": (batch, ssm.conv_width - 1, conv_dim)}


def ssm_decode_state(cfg: ModelCfg, batch: int, device=None) -> dict:
    """Zero decode state: the (B, H, P, N) SSD state and the conv ring
    buffer (B, W - 1, conv_dim), float32."""
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in decode_state_shapes(cfg, batch).items()}


def ssm_decode(p: dict, cfg: ModelCfg, u: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
    """One-token step; u: (B, 1, D) -> (out (B, 1, D), new state).  On a
    mesh each rank steps its own rows, as :func:`ssm_apply` scans them,
    and, head-parallel, its own heads of the SSD state, which stays where
    ``parallel.sharding.cache_specs`` puts it (heads over the model axis)
    from step to step; the conv ring buffer keeps every channel on every
    model rank (its spec replicates it there), so each rank reads the
    step's whole ``x``."""
    plan = head_parallel_plan(cfg, p)
    if plan is None:
        y, ssd, conv = data_parallel(
            lambda x, w, s0, c0: _ssm_decode(w, cfg, x,
                                             {"ssd": s0, "conv": c0}),
            u, p, state["ssd"], state["conv"], n_out=3)
        return y, {"ssd": ssd, "conv": conv}
    from torch.distributed.tensor import Partial, Replicate, Shard
    y, ssd, conv = data_parallel(
        lambda x, w, s0, c0: _ssm_decode_heads(w, cfg, x, s0, c0, plan),
        u, p, state["ssd"], state["conv"], n_out=3,
        tp=plan.placements(p) + [Shard(1), Replicate()],
        tp_out=(Partial(), Shard(1), Replicate()))
    return y, {"ssd": ssd, "conv": conv}


def _ssm_decode_heads(p: dict, cfg: ModelCfg, u: torch.Tensor,
                      ssd: torch.Tensor, conv: torch.Tensor,
                      plan: HeadPlan):
    (z, x, b, c, dt), conv_w, conv_b, lp = plan.local(p, u, whole_xbc=True)
    hist = torch.cat([conv, torch.cat([x, b, c], dim=-1).float()], dim=1)
    return (*_ssd_step(lp, cfg, u, z, dt, plan.channels(hist), conv_w,
                       conv_b, ssd,
                       lambda y: plan.norm(y, lp["norm"])), hist[:, 1:, :])


def _ssm_decode(p: dict, cfg: ModelCfg, u: torch.Tensor, state: dict):
    z, x, b, c, dt = _split_proj(cfg, u @ p["in_proj"])
    hist = torch.cat([state["conv"],
                      torch.cat([x, b, c], dim=-1).float()], dim=1)
    return (*_ssd_step(p, cfg, u, z, dt, hist, p["conv_w"], p["conv_b"],
                       state["ssd"],
                       lambda y: gated_norm(cfg, y, p["norm"])),
            hist[:, 1:, :])


def _ssd_step(p: dict, cfg: ModelCfg, u, z, dt, hist, conv_w, conv_b,
              ssd, norm):
    """The decode step from the conv's history on: ``hist`` (B, W, C)
    float32 (the ring and this step's ``[x | B | C]``, a rank's channels
    on a mesh), the conv, the SSD recurrence on ``ssd`` (B, H, P, N), the
    gate, ``norm`` and ``out_proj``: ``(out, new ssd)``."""
    ssm = cfg.ssm
    n_heads, d_in = dt.shape[-1], z.shape[-1]
    groups = (hist.shape[-1] - d_in) // (2 * ssm.d_state)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, conv_w.float())
                      + conv_b)
    gn = groups * ssm.d_state
    x, b, c = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    bs = x.shape[0]
    dt = softplus(dt[:, 0, :].float() + p["dt_bias"])          # (B,H)
    xh = x.reshape(bs, n_heads, ssm.head_dim)
    a = -torch.exp(p["a_log"])[None, :] * dt                  # (B,H)
    rep = n_heads // groups
    bg = b.reshape(bs, groups, ssm.d_state).repeat_interleave(rep, 1)
    cg = c.reshape(bs, groups, ssm.d_state).repeat_interleave(rep, 1)
    new_ssd = ssd * torch.exp(a)[..., None, None] \
        + (xh * dt[..., None])[..., None] * bg[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_ssd, cg)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bs, 1, d_in).to(u.dtype) * F.silu(z)
    return norm(y) @ p["out_proj"], new_ssd
