"""The plain reference of the LM cells, in float32 PyTorch.

It holds its own copy of every piece of arithmetic the cells run: the
parameter list and its init, RMSNorm, RoPE, causal GQA attention, the
LogicNet-FFN (fan-in masks on the SwiGLU weights, 4-bit activation
quantizers with a straight-through gradient), the Mamba2 block with the
SSD scan (the chunked algorithm of arXiv:2405.21060, written here as its
minimal form), the hybrid's shared block, the tied LM head and the
next-token loss.  It imports nothing of the program and takes nothing the
program made: the harness hands both sides the same weights and tokens.

Every product runs in float32 with TF32 off (:func:`exact_matmuls`).  With
``prec="fp8"`` every weight product instead takes its operands rounded to
float8 e4m3 under a per-tensor scale, and the residual stream is held in
bfloat16 between blocks (both straight-through in backward): the control,
the cells' bfloat16 compute with its products one precision lower.

The config is the cell's JSON dict (``portbench/configs/<name>.json``):
``n_layers``, ``d_model``, ``n_heads``, ``n_kv_heads``, ``head_dim``,
``d_ff``, ``vocab``, ``qk_norm``, ``rope_theta``, ``norm_eps``,
``logicnet_ffn`` and, for the hybrid, ``block_kind: "ssm"``, ``ssm`` and
``hybrid_attn_every``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# query rows a block of the attention's scores holds
QUERY_BLOCK = 1024
# tokens a block of the loss's logits holds
LOSS_BLOCK = 2048
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
        torch.set_float32_matmul_precision(was[2])


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax to
    448), back in float32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def stream(h: torch.Tensor, prec: str) -> torch.Tensor:
    """The residual stream as the precision holds it between blocks."""
    if prec == "fp8":
        return h + (h.detach().to(torch.bfloat16).float() - h.detach())
    return h


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """A weight product ``a @ b`` at the reference's precision."""
    if prec == "fp8":
        return _fp8(a) @ _fp8(b)
    return a @ b


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def is_hybrid(cfg: dict) -> bool:
    return cfg.get("block_kind", "attn") == "ssm"


def ssm_dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """``(d_in, heads, head_dim, groups, d_state)`` of a Mamba2 layer."""
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    return d_in, d_in // s["head_dim"], s["head_dim"], s["n_groups"], \
        s["d_state"]


def fan_ins(cfg: dict) -> tuple[int, int]:
    """Kept inputs a hidden neuron reads (of ``d_model``) and an output
    neuron reads (of ``d_ff``)."""
    k = cfg["logicnet_ffn"]["fan_in"]
    return min(k, cfg["d_model"]), min(k, cfg["d_ff"])


def _decoder_specs(cfg: dict, prefix: str) -> list:
    d, hd, dff = cfg["d_model"], head_dim(cfg), cfg["d_ff"]
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    s = d ** -0.5
    out = [(f"{prefix}.ln1", (d,), ("zeros",)),
           (f"{prefix}.ln2", (d,), ("zeros",)),
           (f"{prefix}.attn.wq", (d, h, hd), ("normal", s)),
           (f"{prefix}.attn.wk", (d, hkv, hd), ("normal", s)),
           (f"{prefix}.attn.wv", (d, hkv, hd), ("normal", s)),
           (f"{prefix}.attn.wo", (h, hd, d), ("normal", s))]
    if cfg.get("qk_norm"):
        out += [(f"{prefix}.attn.q_norm", (hd,), ("zeros",)),
                (f"{prefix}.attn.k_norm", (hd,), ("zeros",))]
    out += [(f"{prefix}.ffn.wi_gate", (d, dff), ("normal", s)),
            (f"{prefix}.ffn.wi_up", (d, dff), ("normal", s)),
            (f"{prefix}.ffn.wo", (dff, d), ("normal", dff ** -0.5))]
    if cfg.get("logicnet_ffn"):
        out += [(f"{prefix}.ffn.mask_in", (d, dff), ("mask_in",)),
                (f"{prefix}.ffn.mask_out", (dff, d), ("mask_out",))]
    return out


def param_specs(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, init)`` of every parameter.  Inits: ``("normal",
    std)``, ``("zeros",)``, ``("ones",)``, ``("a_log",)`` (log of 1..16
    spread over the heads), ``("mask_in",)`` / ``("mask_out",)`` (the one
    pair of fan-in masks every layer shares)."""
    d, v = cfg["d_model"], cfg["vocab"]
    out = [("embed.tok", (v, d), ("normal", 0.02)),
           ("final_norm", (d,), ("zeros",))]
    if not is_hybrid(cfg):
        for i in range(cfg["n_layers"]):
            out += _decoder_specs(cfg, f"layers.{i}")
        return out
    d_in, nh, _, g, n = ssm_dims(cfg)
    width = cfg["ssm"]["conv_width"]
    conv = d_in + 2 * g * n
    for i in range(cfg["n_layers"]):
        p = f"ssm_layers.{i}"
        out += [(f"{p}.ln", (d,), ("zeros",)),
                (f"{p}.ssm.in_proj", (d, 2 * d_in + 2 * g * n + nh),
                 ("normal", d ** -0.5)),
                (f"{p}.ssm.conv_w", (width, conv), ("normal", 0.2)),
                (f"{p}.ssm.conv_b", (conv,), ("zeros",)),
                (f"{p}.ssm.a_log", (nh,), ("a_log",)),
                (f"{p}.ssm.d_skip", (nh,), ("ones",)),
                (f"{p}.ssm.dt_bias", (nh,), ("zeros",)),
                (f"{p}.ssm.norm", (d_in,), ("zeros",)),
                (f"{p}.ssm.out_proj", (d_in, d), ("normal", d_in ** -0.5))]
    return out + _decoder_specs(cfg, "shared_attn")


# ---------------------------------------------------------------- blocks

def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0..S-1: the two halves of D rotated."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def quantize(x: torch.Tensor, bits: int, max_val: float) -> torch.Tensor:
    """4-bit ReLU quantizer: levels 0..2^b-1 times max/(2^b-1), half to
    even; the gradient is the clip's."""
    step = max_val / (2 ** bits - 1)
    c = torch.clamp(x, 0.0, max_val)
    return c + (torch.round(c.detach() / step) * step - c).detach()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA softmax attention, float32: q (B, S, H, D), k and v (B,
    S, Hkv, D); q head h reads kv head h // (H / Hkv).  Blocks of
    ``QUERY_BLOCK`` query rows against the keys up to each block's end."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d) * d ** -0.5
    out = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(s, q0 + QUERY_BLOCK)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q1], k[:, :q1])
        causal = (torch.arange(q1, device=q.device)[None, :]
                  <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = sc.masked_fill(~causal, float("-inf"))
        out.append(torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, -1),
                                v[:, :q1]))
    return torch.cat(out, dim=1).reshape(b, s, h, d)


def ffn(p: dict, x: torch.Tensor, cfg: dict, prec: str) -> torch.Tensor:
    """The LogicNet-FFN: quantize, masked SwiGLU, quantize, masked output
    product (rows of x flattened)."""
    q = cfg["logicnet_ffn"]
    bits, top = q["bw"], q["max_val"]
    lead = x.shape[:-1]
    xq = quantize(x.reshape(-1, x.shape[-1]), bits, top)
    g = mm(xq, p["wi_gate"] * p["mask_in"], prec)
    u = mm(xq, p["wi_up"] * p["mask_in"], prec)
    hq = quantize(F.silu(g) * u, bits, top)
    return mm(hq, p["wo"] * p["mask_out"], prec).reshape(*lead, -1)


def attn_block(p: dict, h: torch.Tensor, cfg: dict, prec: str
               ) -> torch.Tensor:
    """A decoder layer (or the hybrid's shared one): attention and the
    LogicNet-FFN on the residual stream ``h`` (B, S, D)."""
    b, s, d = h.shape
    eps, hd = cfg["norm_eps"], head_dim(cfg)
    x = rms(h, p["ln1"], eps).reshape(b * s, d)
    q = mm(x, p["attn.wq"].reshape(d, -1), prec).reshape(b, s, -1, hd)
    k = mm(x, p["attn.wk"].reshape(d, -1), prec).reshape(b, s, -1, hd)
    v = mm(x, p["attn.wv"].reshape(d, -1), prec).reshape(b, s, -1, hd)
    if cfg.get("qk_norm"):
        q = rms(q, p["attn.q_norm"], eps)
        k = rms(k, p["attn.k_norm"], eps)
    theta = cfg["rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v)
    h = stream(h + mm(o.reshape(b * s, -1), p["attn.wo"].reshape(-1, d),
                      prec).reshape(b, s, d), prec)
    ffn_p = {k[4:]: t for k, t in p.items() if k.startswith("ffn.")}
    return stream(h + ffn(ffn_p, rms(h, p["ln2"], eps), cfg, prec), prec)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): S[i, j] = x[j+1] + ... + x[i] for j <= i,
    -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan, minimal chunked form: y_t = sum_{s<=t} (C_t . B_s)
    exp(a_{s+1} + ... + a_t) x_s.  x (B, S, H, P); a (B, S, H); bm, cm
    (B, S, H, N) (the groups spread over their heads)."""
    b, s, h, p = x.shape
    c = s // chunk
    x = x.reshape(b, c, chunk, h, p)
    bm = bm.reshape(b, c, chunk, h, -1)
    cm = cm.reshape(b, c, chunk, h, -1)
    a = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (B,H,C,L)
    a_cs = torch.cumsum(a, dim=-1)
    # within a chunk
    decay = torch.exp(_segsum(a))                             # (B,H,C,L,L)
    cb = torch.einsum("bclhn,bcshn->bhcls", cm, bm)
    y = torch.einsum("bhcls,bcshp->bclhp", cb * decay, x)
    # each chunk's final state, then the state entering each chunk
    to_end = torch.exp(a_cs[..., -1:] - a_cs)                 # (B,H,C,L)
    states = torch.einsum("bclhn,bclhp->bchpn", bm,
                          x * to_end.permute(0, 2, 3, 1)[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))  # (B,H,C+1,C+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    from_start = torch.exp(a_cs).permute(0, 2, 3, 1)          # (B,C,L,H)
    y = y + torch.einsum("bclhn,bchpn->bclhp", cm, entering) \
        * from_start[..., None]
    return y.reshape(b, s, h, p)


def ssm_block(p: dict, h: torch.Tensor, cfg: dict, prec: str
              ) -> torch.Tensor:
    """A Mamba2 layer on the residual stream ``h`` (B, S, D)."""
    b, s, d = h.shape
    d_in, nh, hp, g, n = ssm_dims(cfg)
    u = rms(h, p["ln"], cfg["norm_eps"]).reshape(b * s, d)
    zxbcdt = mm(u, p["ssm.in_proj"], prec).reshape(b, s, -1)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], dim=-1)
    w = p["ssm.conv_w"]
    pad = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(w.shape[0]))
    xbc = F.silu(conv + p["ssm.conv_b"])
    x, bm, cm = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = torch.logaddexp(dt + p["ssm.dt_bias"], torch.zeros((), device=h.device))
    a = -torch.exp(p["ssm.a_log"]) * dt                       # (B,S,H)
    xh = x.reshape(b, s, nh, hp)
    per = nh // g
    bm = bm.reshape(b, s, g, 1, n).expand(b, s, g, per, n).reshape(b, s, nh, n)
    cm = cm.reshape(b, s, g, 1, n).expand(b, s, g, per, n).reshape(b, s, nh, n)
    y = ssd(xh * dt[..., None], a, bm, cm, min(cfg["ssm"]["chunk"], s))
    y = (y + xh * p["ssm.d_skip"][:, None]).reshape(b, s, d_in) * F.silu(z)
    y = rms(y, p["ssm.norm"], cfg["norm_eps"]).reshape(b * s, d_in)
    return stream(h + mm(y, p["ssm.out_proj"], prec).reshape(b, s, d), prec)


def _group(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: t for k, t in params.items() if k.startswith(prefix + ".")}


def hidden(params: dict, cfg: dict, tokens: torch.Tensor, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S); with
    ``remat`` each layer is recomputed in backward."""
    def run(block, p, h):
        if remat:
            return checkpoint(block, p, h, cfg, prec, use_reentrant=False)
        return block(p, h, cfg, prec)

    h = stream(params["embed.tok"][tokens.long()], prec)
    if is_hybrid(cfg):
        shared = _group(params, "shared_attn")
        every = cfg["hybrid_attn_every"]
        for i in range(cfg["n_layers"]):
            if i % every == 0:
                h = run(attn_block, shared, h)
            h = run(ssm_block, _group(params, f"ssm_layers.{i}"), h)
    else:
        for i in range(cfg["n_layers"]):
            h = run(attn_block, _group(params, f"layers.{i}"), h)
    return rms(h, params["final_norm"], cfg["norm_eps"])


def _block_nll(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
               prec: str) -> torch.Tensor:
    logits = mm(h, emb.t(), prec)
    gold = logits.gather(1, labels[:, None]).squeeze(1)
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def loss(params: dict, cfg: dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of the tied LM head, every layer and
    every block of ``LOSS_BLOCK`` tokens of logits recomputed in
    backward."""
    h = hidden(params, cfg, tokens, prec, remat=True)
    h = h.reshape(-1, h.shape[-1])
    lab = labels.reshape(-1).long()
    total = sum(checkpoint(_block_nll, h[i:i + LOSS_BLOCK],
                           params["embed.tok"], lab[i:i + LOSS_BLOCK], prec,
                           use_reentrant=False)
                for i in range(0, h.shape[0], LOSS_BLOCK))
    return total / lab.numel()


@torch.no_grad()
def last_logits(params: dict, cfg: dict, tokens: torch.Tensor,
                prec: str = "f32") -> torch.Tensor:
    """(B, vocab) float32 logits at each sequence's last position."""
    h = hidden(params, cfg, tokens, prec)[:, -1]
    return mm(h, params["embed.tok"].t(), prec)
