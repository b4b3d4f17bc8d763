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

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelCfg
from repro_torch.models.layers import init_rms, normal_init, rms_norm


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


def ssm_apply(p: dict, cfg: ModelCfg, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence mamba2 block; u: (B, S, D)."""
    ssm = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    z, x, b, c, dt = _split_proj(cfg, u @ p["in_proj"])
    xbc = _causal_conv(torch.cat([x, b, c], dim=-1), p["conv_w"],
                       p["conv_b"])
    gn = ssm.n_groups * ssm.d_state
    x, b, c = torch.split(xbc, [d_in, gn, gn], dim=-1)
    bs, s, _ = x.shape
    dt = softplus(dt.float() + p["dt_bias"])                  # (B,S,H)
    xh = x.reshape(bs, s, n_heads, ssm.head_dim)
    a = -torch.exp(p["a_log"])[None, None, :] * dt            # (B,S,H)
    bg = b.reshape(bs, s, ssm.n_groups, ssm.d_state)
    cg = c.reshape(bs, s, ssm.n_groups, ssm.d_state)
    y, _ = ssd_chunked(xh * dt[..., None].to(xh.dtype), a, bg, cg,
                       min(ssm.chunk, s))
    y = y + xh * p["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(bs, s, d_in) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


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
    """One-token step; u: (B, 1, D) -> (out (B, 1, D), new state)."""
    ssm = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    z, x, b, c, dt = _split_proj(cfg, u @ p["in_proj"])
    xbc = torch.cat([x, b, c], dim=-1)[:, 0, :]              # (B, conv_dim)
    hist = torch.cat([state["conv"], xbc[:, None, :].float()], dim=1)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"].float())
                      + p["conv_b"])
    new_conv = hist[:, 1:, :]
    gn = ssm.n_groups * ssm.d_state
    x, b, c = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    bs = x.shape[0]
    dt = softplus(dt[:, 0, :].float() + p["dt_bias"])          # (B,H)
    xh = x.reshape(bs, n_heads, ssm.head_dim)
    a = -torch.exp(p["a_log"])[None, :] * dt                  # (B,H)
    rep = n_heads // ssm.n_groups
    bg = b.reshape(bs, ssm.n_groups, ssm.d_state).repeat_interleave(rep, 1)
    cg = c.reshape(bs, ssm.n_groups, ssm.d_state).repeat_interleave(rep, 1)
    new_ssd = state["ssd"] * torch.exp(a)[..., None, None] \
        + (xh * dt[..., None])[..., None] * bg[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_ssd, cg)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bs, 1, d_in).to(u.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"ssd": new_ssd, "conv": new_conv}
