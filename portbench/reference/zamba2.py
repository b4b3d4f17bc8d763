"""The plain reference of Zamba2's layout (Zamba2-7B-Instruct), in float32
PyTorch.

Zyphra's Zamba2 (arXiv:2411.15242, after arXiv:2405.16712), as
``huggingface.co/Zyphra/Zamba2-7B-Instruct``'s ``config.json`` and the
``transformers`` Zamba2 model describe it.  With ``e`` the embedding of
the tokens, ``h_0 = e``, and for each Mamba2 layer ``i`` of ``n_layers``:

    h_{i+1} = h_i + mamba_i(norm_i(h_i + t_i))

where ``t_i = 0`` except at the layers of ``hybrid_layer_ids``; at the
``j``-th of them shared block ``j mod num_mem_blocks`` (A, B, A, B, ...)
runs, with that site's own LoRA and ``linear``:

    x   = ln1(concat(h_i, e))                   2 d_model wide
    a   = attention(x) wo                       causal, RoPE on all of
                                                head_dim, scores scaled by
                                                (head_dim / 2)^-0.5
    y   = ln2(a)
    g|u = y [wi_gate | wi_up] + (y lora_a) lora_b    gate half first
    t_i = (gelu(g) * u) wo_ffn  linear              exact (erf) GELU

The block has no residual: ``t_i`` enters only layer ``i``'s mixer input,
and the residual is ``h_i``.  A Mamba2 mixer (``in_proj`` packs ``[z | x |
B | C | dt]``): a depthwise causal conv of width ``conv_width`` with bias
and SiLU over ``[x | B | C]``; ``dt = softplus(dt + dt_bias)``; ``A =
-exp(a_log)``; the SSD scan of heads of ``head_dim`` with ``n_groups``
groups of ``B`` and ``C`` (state ``d_state``, chunks of ``chunk``); ``y +
D x``; ``y * silu(z)``; an RMSNorm taken over each of the ``n_groups``
groups of ``d_in / n_groups`` channels; ``out_proj``.  Then a final
RMSNorm and the tied head.  Every RMSNorm scales by ``1 + w`` (``w`` 0 at
init), the published ``w`` (1 at init) less one.

Departures from the source, each shared with the program: ``dt`` is not
clamped below at ``time_step_min`` (0.001), which ``transformers``'s
torch path does (the program's Mamba2 mixer has no clamp; with these
weights ``softplus`` reads under 0.001 only below -6.9); the weights are
random (the harness's draws), the embedding tied (the source's config
does not set ``tie_word_embeddings``; ``PretrainedConfig`` ties by
default).

It reuses ``model.py``'s plain ``rms``, ``rope``, ``ssd``, ``ssm_dims``
and the blocked loss; the grouped gated norm, the concatenation, the two
blocks, the LoRA, the site ``linear`` and the residual rule are its own.
Imports nothing of the program, of JAX or of ``transformers``.  The
precisions ``prec`` names are :mod:`portbench.reference.precision`'s.
The config is the cell's JSON dict (``portbench/configs/zamba2-7b.json``):
``n_layers``, ``d_model``, ``n_heads``, ``n_kv_heads``, ``head_dim``,
``d_ff``, ``vocab``, ``ssm``, ``hybrid_layer_ids``, ``num_mem_blocks``,
``adapter_rank``, ``rope_theta``, ``norm_eps``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import (LOSS_BLOCK, QUERY_BLOCK, _block_nll,
                                       rms, rope, ssd, ssm_dims)
from portbench.reference.precision import mm, stream


def param_specs(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, init)`` of every parameter, in the program's names:
    ``embed.tok``, ``final_norm``, ``ssm_layers.<i>.*``,
    ``shared_blocks.<b>.*`` and ``sites.<j>.*``."""
    d, v, dff = cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    h, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    r, d2 = cfg["adapter_rank"], 2 * cfg["d_model"]
    d_in, nh, _, g, n = ssm_dims(cfg)
    width = cfg["ssm"]["conv_width"]
    conv = d_in + 2 * g * n
    out = [("embed.tok", (v, d), ("normal", 0.02)),
           ("final_norm", (d,), ("zeros",))]
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
    for b in range(cfg["num_mem_blocks"]):
        p = f"shared_blocks.{b}"
        out += [(f"{p}.ln1", (d2,), ("zeros",)),
                (f"{p}.ln2", (d,), ("zeros",)),
                (f"{p}.attn.wq", (d2, h, hd), ("normal", d2 ** -0.5)),
                (f"{p}.attn.wk", (d2, hkv, hd), ("normal", d2 ** -0.5)),
                (f"{p}.attn.wv", (d2, hkv, hd), ("normal", d2 ** -0.5)),
                (f"{p}.attn.wo", (h, hd, d), ("normal", d2 ** -0.5)),
                (f"{p}.ffn.wi_gate", (d, dff), ("normal", d ** -0.5)),
                (f"{p}.ffn.wi_up", (d, dff), ("normal", d ** -0.5)),
                (f"{p}.ffn.wo", (dff, d), ("normal", dff ** -0.5))]
    for j in range(len(cfg["hybrid_layer_ids"])):
        p = f"sites.{j}"
        out += [(f"{p}.linear", (d, d), ("normal", d ** -0.5)),
                (f"{p}.lora_a", (d, r), ("normal", d ** -0.5)),
                (f"{p}.lora_b", (r, 2 * dff), ("normal", r ** -0.5))]
    return out


# ---------------------------------------------------------------- blocks

def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, x Phi(x) (``transformers``'s ``"gelu"``)."""
    return F.gelu(x)


def attn_scale(cfg: dict) -> float:
    return (cfg["head_dim"] / 2) ** -0.5


def block_of(site: int, cfg: dict) -> int:
    """The shared block site ``site`` runs: the blocks in turn."""
    return site % cfg["num_mem_blocks"]


def gated_norm(y: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """RMSNorm over each of ``groups`` equal groups of the last dim."""
    lead = y.shape[:-1]
    out = rms(y.reshape(*lead, groups, -1), scale.reshape(groups, -1), eps)
    return out.reshape(*lead, -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Causal softmax attention, float32, scores scaled by ``scale``: q
    (B, S, H, D), k and v (B, S, Hkv, D), q head h reading kv head h //
    (H / Hkv), in blocks of ``QUERY_BLOCK`` query rows."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d) * scale
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


def lora(site: dict, y: torch.Tensor, prec: str) -> torch.Tensor:
    """The site's adapter on the packed gate_up product: (y a) b."""
    return mm(mm(y, site["lora_a"], prec), site["lora_b"], prec)


def shared_block(p: dict, site: dict, h: torch.Tensor, e: torch.Tensor,
                 cfg: dict, prec: str) -> torch.Tensor:
    """A shared block ``p`` at a site with the site's weights ``site``:
    the site's ``linear`` of the block's output T, (B, S, D)."""
    b, s, d = h.shape
    eps, hd, theta = cfg["norm_eps"], cfg["head_dim"], cfg["rope_theta"]
    x = rms(torch.cat([h, e], dim=-1), p["ln1"], eps).reshape(b * s, 2 * d)
    q = mm(x, p["attn.wq"].reshape(2 * d, -1), prec).reshape(b, s, -1, hd)
    k = mm(x, p["attn.wk"].reshape(2 * d, -1), prec).reshape(b, s, -1, hd)
    v = mm(x, p["attn.wv"].reshape(2 * d, -1), prec).reshape(b, s, -1, hd)
    o = attention(rope(q, theta), rope(k, theta), v, attn_scale(cfg))
    a = mm(o.reshape(b * s, -1), p["attn.wo"].reshape(-1, d), prec)
    y = rms(a, p["ln2"], eps)
    d_gate, d_up = lora(site, y, prec).chunk(2, dim=-1)
    f = gelu(mm(y, p["ffn.wi_gate"], prec) + d_gate) \
        * (mm(y, p["ffn.wi_up"], prec) + d_up)
    t = mm(mm(f, p["ffn.wo"], prec), site["linear"], prec)
    return stream(t.reshape(b, s, d), prec)


def ssm_block(p: dict, h: torch.Tensor, t: torch.Tensor | None, cfg: dict,
              prec: str) -> torch.Tensor:
    """A Mamba2 layer on the residual stream ``h`` (B, S, D), the site's
    ``t`` (or None) added to its input and not to the residual."""
    b, s, d = h.shape
    d_in, nh, hp, g, n = ssm_dims(cfg)
    x_in = h if t is None else h + t
    u = rms(x_in, p["ln"], cfg["norm_eps"]).reshape(b * s, d)
    zxbcdt = mm(u, p["ssm.in_proj"], prec).reshape(b, s, -1)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, nh], dim=-1)
    w = p["ssm.conv_w"]
    pad = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(w.shape[0]))
    xbc = F.silu(conv + p["ssm.conv_b"])
    x, bm, cm = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = torch.logaddexp(dt + p["ssm.dt_bias"],
                         torch.zeros((), device=h.device))
    a = -torch.exp(p["ssm.a_log"]) * dt                       # (B,S,H)
    xh = x.reshape(b, s, nh, hp)
    per = nh // g
    bm = bm.reshape(b, s, g, 1, n).expand(b, s, g, per, n).reshape(b, s, nh, n)
    cm = cm.reshape(b, s, g, 1, n).expand(b, s, g, per, n).reshape(b, s, nh, n)
    y = ssd(xh * dt[..., None], a, bm, cm, min(cfg["ssm"]["chunk"], s))
    y = (y + xh * p["ssm.d_skip"][:, None]).reshape(b, s, d_in) * F.silu(z)
    y = gated_norm(y, p["ssm.norm"], g, cfg["norm_eps"]).reshape(b * s, d_in)
    return stream(h + mm(y, p["ssm.out_proj"], prec).reshape(b, s, d), prec)


def _group(params: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: t for k, t in params.items() if k.startswith(prefix + ".")}


def hidden(params: dict, cfg: dict, tokens: torch.Tensor, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) of ``tokens`` (B, S); with
    ``remat`` each block and each layer is recomputed in backward."""
    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, cfg, prec, use_reentrant=False)
        return fn(*args, cfg, prec)

    e = stream(params["embed.tok"][tokens.long()], prec)
    sites = {layer: j for j, layer in enumerate(cfg["hybrid_layer_ids"])}
    h = e
    for i in range(cfg["n_layers"]):
        t = None
        if i in sites:
            j = sites[i]
            t = run(shared_block,
                    _group(params, f"shared_blocks.{block_of(j, cfg)}"),
                    _group(params, f"sites.{j}"), h, e)
        h = run(ssm_block, _group(params, f"ssm_layers.{i}"), h, t)
    return rms(h, params["final_norm"], cfg["norm_eps"])


def loss(params: dict, cfg: dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of the tied LM head, every block,
    layer and block of ``LOSS_BLOCK`` tokens of logits recomputed in
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


# ------------------------------------------------------------- model FLOPs
#
# model.py's convention: every weight product at 2 FLOP a weight a token,
# causal attention at 4 head_dim heads a (query, key) pair with key <=
# query, the SSD at 6 d_state head_dim a head a token, the LM head at the
# positions whose logits are used; norms, activations, RoPE, softmax and
# the convolution are not counted.

def token_weights(cfg: dict) -> int:
    """Weights a token multiplies once in a forward, LM head apart: every
    Mamba2 layer's projections, and at each site the shared block's (q, k
    and v reading 2 d_model), the LoRA and the site's ``linear``."""
    d, dff, hd, r = cfg["d_model"], cfg["d_ff"], cfg["head_dim"], \
        cfg["adapter_rank"]
    d_in, nh, _, g, n = ssm_dims(cfg)
    mamba = d * (2 * d_in + 2 * g * n + nh) + d_in * d
    site = (2 * d * hd * (cfg["n_heads"] + 2 * cfg["n_kv_heads"])
            + cfg["n_heads"] * hd * d + 3 * d * dff
            + r * (d + 2 * dff) + d * d)
    return cfg["n_layers"] * mamba + len(cfg["hybrid_layer_ids"]) * site


def forward_flops(cfg: dict, batch: int, seq: int, head_rows: int) -> float:
    """Model FLOPs of a forward over ``batch`` sequences of ``seq`` tokens
    with the LM head at ``head_rows`` positions."""
    tokens = batch * seq
    _, nh, hp, _, n = ssm_dims(cfg)
    pairs = batch * seq * (seq + 1) / 2
    return (2.0 * token_weights(cfg) * tokens
            + 4.0 * cfg["head_dim"] * cfg["n_heads"] * pairs
            * len(cfg["hybrid_layer_ids"])
            + 6.0 * n * hp * nh * tokens * cfg["n_layers"]
            + 2.0 * cfg["vocab"] * cfg["d_model"] * head_rows)
