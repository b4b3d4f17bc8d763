"""The port's LM training path with the LogicNet-FFN against the
reference's, on the CPU.

The reference (``repro.models``, ``repro.launch.steps``, ``repro.optim``)
runs under JAX on the CPU; the port (``repro_torch.models``,
``repro_torch.launch.steps``) runs its plain versions on CPU tensors, the
masked-matmul kernel's included.  Both start from the reference's
``init_params`` at PRNGKey(0) for the qwen3-1.7b smoke config with
``LogicNetFFNCfg()`` (fan-in 16, 4 bits, max 4.0), carried into the port
by ``from_reference``, and see the same ``TokenStream`` batches.
Tolerances:

* logits at float32 compute: atol 1e-4 / rtol 1e-4 (``test_torch_lm``'s;
  the same arithmetic in another summation order); at bfloat16: atol 0.05
  / rtol 0.05, the reference's own decode-against-forward contract;
* the global gradient norm, mask gradients included, at float32: rtol
  1e-5 (measured 1e-7);
* five AdamW steps: losses within rtol 1e-3 at either compute dtype
  (measured 3e-7 at float32, 1.2e-5 at bfloat16); parameters after them,
  at float32 compute, within atol 1e-5 (measured 6e-6).  AdamW's first
  steps move an element by about lr = 3e-4 along the sign of its
  gradient, so one element whose gradient changed sign would miss by
  6e-4; at bfloat16 compute 2 166 of 123 264 elements do, so parameters
  are compared at float32 only.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from torch_port_util import one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.data import TokenStream as RefTokenStream
from repro.launch import steps as RS
from repro.models import layers as RL
from repro.models import model as RM
from repro.models.config import LogicNetFFNCfg as RefLogicNetFFNCfg
from repro.optim import adamw as RA
from repro_torch import configs as PC
from repro_torch.core.sparsity import apriori_mask
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.masked_matmul import (MaskedMatmulFn,
                                               masked_matmul_plain)
from repro_torch.launch import serve_lm, steps, train
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import LogicNetFFNCfg
from repro_torch.optim import AdamWCfg, cosine_schedule, global_norm

TIGHT = {"atol": 1e-4, "rtol": 1e-4}
BF16 = {"atol": 0.05, "rtol": 0.05}
SEQ, BATCH, STEPS, LR = 64, 4, 5, 3e-4


def _cfgs(compute_dtype="float32", **kw):
    ref = dataclasses.replace(RC.get_smoke_config("qwen3-1.7b"),
                              logicnet_ffn=RefLogicNetFFNCfg(),
                              compute_dtype=compute_dtype, **kw)
    port = dataclasses.replace(PC.get_smoke_config("qwen3-1.7b"),
                               logicnet_ffn=LogicNetFFNCfg(),
                               compute_dtype=compute_dtype, **kw)
    return ref, port


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _per_layer(cfg, flat: dict, name: str) -> np.ndarray:
    stack, rest = name.split(".", 1)
    return np.stack([flat[f"{stack}.{i}.{rest}"]
                     for i in range(cfg.n_layers)])


def _state(params: dict) -> dict:
    from repro_torch.optim import init_opt_state
    p = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    return {"params": p, "opt": init_opt_state(p)}


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def ref_params():
    """The reference's LogicNet-FFN smoke params at PRNGKey(0) (its init
    does not depend on the compute dtype)."""
    return RM.init_params(_cfgs()[0], jax.random.PRNGKey(0))


def _port_model(cfg, ref_params):
    return M.from_reference(cfg, _flat(ref_params), device="cpu")


# ---------------------------------------------------------------------------
# init, masks, the FFN
# ---------------------------------------------------------------------------

def test_masks_equal_reference_bit_for_bit(ref_params):
    """The port's own init draws the reference's masks, the same for every
    layer, exactly 16 ones a column."""
    _, cfg = _cfgs()
    model = steps.init_params(cfg, seed=3, device="cpu")
    got = dict(model.named_parameters())
    for name in ("mask_in", "mask_out"):
        want = np.asarray(ref_params["layers"]["ffn"][name])
        assert want.shape[0] == cfg.n_layers
        np.testing.assert_array_equal(
            _per_layer(cfg, {n: t.numpy() for n, t in got.items()},
                       f"layers.ffn.{name}"), want)
        assert (want.sum(axis=1) == 16).all()
    np.testing.assert_array_equal(
        L.logicnet_masks(cfg.d_model, cfg.d_ff, cfg.logicnet_ffn)[0].numpy(),
        apriori_mask(0, cfg.d_model, cfg.d_ff, 16).numpy())
    assert got["layers.0.ffn.mask_in"].data_ptr() != \
        got["layers.1.ffn.mask_in"].data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logicnet_ffn_apply_matches_reference(ref_params, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 2).astype(np.float32)
    ffn = jax.tree.map(lambda a: a[0], ref_params["layers"]["ffn"])
    want = RL.logicnet_ffn_apply(
        jax.tree.map(lambda a: a.astype(dtype), ffn),
        jnp.asarray(x, dtype), RefLogicNetFFNCfg())
    p = {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
         for k, v in ffn.items()}
    got = L.logicnet_ffn_apply(p, torch.from_numpy(x).to(p["wo"].dtype),
                               LogicNetFFNCfg())
    assert got.shape == (2, 5, 64) and got.dtype == p["wo"].dtype
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(TIGHT if dtype == "float32" else BF16))


def test_masked_matmul_fn_mask_gradient_matches_plain_autograd():
    """dx, dw and the mask's gradient (x^T dy) * w against autograd of the
    plain version; a mask without grad gets None, as before."""
    rng = np.random.default_rng(1)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((9, 16), (16, 12)))
    mask = torch.from_numpy((rng.random((16, 12)) < 0.4).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, mask)]
    plain = [t.clone().requires_grad_() for t in (x, w, mask)]
    dy = torch.from_numpy(rng.standard_normal((9, 12)).astype(np.float32))
    MaskedMatmulFn.apply(*leaves).backward(dy)
    masked_matmul_plain(*plain).backward(dy)
    for a, p in zip(leaves, plain):
        torch.testing.assert_close(a.grad, p.grad, atol=1e-5, rtol=1e-5)
    assert leaves[2].grad.abs().sum() > 0
    frozen = mask.clone()
    wi = w.clone().requires_grad_()
    MaskedMatmulFn.apply(x, wi, frozen).backward(dy)
    assert frozen.grad is None and wi.grad is not None


# ---------------------------------------------------------------------------
# forward, decode, the loss and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(ref_params, compute_dtype):
    """The serving forward (flash prefill, masked-matmul FFN) and the
    training forward (chunked attention, casts under autograd) both hold
    the reference's logits."""
    rcfg, cfg = _cfgs(compute_dtype)
    model = _port_model(cfg, ref_params)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, SEQ)).astype(np.int32)
    tol = TIGHT if compute_dtype == "float32" else BF16
    want = jax.jit(lambda p, t: RM.forward(p, rcfg, {"tokens": t})[0])(
        ref_params, tokens)
    got = M.forward(model, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    params = {n: p.detach() for n, p in model.named_parameters()}
    trained = M.train_forward(params, cfg, {"tokens": torch.from_numpy(
        tokens)})
    np.testing.assert_allclose(_f32(trained), _f32(want), **tol)
    last = steps.make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(
        tokens)})
    np.testing.assert_allclose(_f32(last), _f32(want)[:, -1], **tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(ref_params, compute_dtype):
    """12 tokens fed one at a time (row 1 three positions ahead): every
    decode step's FFN is three masked products at M = 2 rows."""
    rcfg, cfg = _cfgs(compute_dtype)
    model = _port_model(cfg, ref_params)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    rcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          RM.init_cache(rcfg, 2, 16))
    cache = {k: v.float() for k, v in
             M.init_cache(cfg, 2, 16, device="cpu").items()}
    rdecode = jax.jit(RS.make_decode_step(rcfg))
    decode = steps.make_decode_step(cfg)
    tol = TIGHT if compute_dtype == "float32" else BF16
    for t in range(12):
        pos = np.asarray([t, t + 3], np.int32)
        want, rcache = rdecode(ref_params, rcache, tokens[:, t:t + 1], pos)
        got, cache = decode(model, cache, torch.from_numpy(tokens[:, t:t + 1]),
                            torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"step {t}")


def _batch(cfg, step=0) -> dict:
    return RefTokenStream(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                          seed=0).batch(step)


def test_gradient_norm_with_mask_gradients_matches_reference(ref_params):
    """The reference differentiates its whole parameter tree, so the clip
    norm counts the masks' gradients, (x^T dy) * w; the port's masks
    require grad for the same norm.  Every leaf's gradient too."""
    rcfg, cfg = _cfgs("float32")
    batch = _batch(cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, batch)))(ref_params)
    params = _state({n: p for n, p in
                     _port_model(cfg, ref_params).named_parameters()})[
                         "params"]
    loss = M.loss_fn(params, cfg, _torch_batch(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    want = float(RA.global_norm(rgrads))
    got = float(global_norm(grads.values()))
    assert abs(got - want) <= 1e-5 * want
    masks = [g for n, g in grads.items() if "mask" in n]
    assert len(masks) == 2 * cfg.n_layers
    assert all(float(g.abs().max()) > 0 for g in masks)
    rflat = _flat(rgrads)
    gflat = {n: g.numpy() for n, g in grads.items()}
    for name, g in rflat.items():
        got_g = _per_layer(cfg, gflat, name) if name.startswith(
            "layers.") else gflat[name]
        np.testing.assert_allclose(got_g, g, atol=1e-6,
                                   rtol=1e-4, err_msg=name)


def test_remat_changes_no_number(ref_params):
    """``remat="full"`` recomputes each layer in backward: loss and every
    gradient equal the run without it bit for bit."""
    outs = []
    for remat in ("none", "full"):
        _, cfg = _cfgs("bfloat16", remat=remat)
        params = _state({n: p for n, p in _port_model(
            cfg, ref_params).named_parameters()})["params"]
        loss = M.loss_fn(params, cfg, _torch_batch(_batch(cfg)))
        outs.append([loss, *torch.autograd.grad(loss,
                                                list(params.values()))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def five_steps(request, ref_params):
    """Five steps of each package's train step from the same params and
    batches (AdamW lr 3e-4, weight decay 0.01, cosine with 1 warmup step):
    (cfg, reference losses, port losses, reference params, port state)."""
    rcfg, cfg = _cfgs(request.param)
    rstep = jax.jit(RS.make_train_step(rcfg, RA.AdamWCfg(
        lr=LR, weight_decay=0.01, schedule=RA.cosine_schedule(1, STEPS))))
    step = steps.make_train_step(cfg, AdamWCfg(
        lr=LR, weight_decay=0.01, schedule=cosine_schedule(1, STEPS)))
    rstate = {"params": ref_params, "opt": RA.init_opt_state(ref_params)}
    state = _state(dict(_port_model(cfg, ref_params).named_parameters()))
    rlosses, losses = [], []
    for i in range(STEPS):
        b = _batch(cfg, i)
        rstate, rl = rstep(rstate, b)
        state, loss = step(state, _torch_batch(b))
        rlosses.append(float(rl))
        losses.append(float(loss))
    return cfg, rlosses, losses, rstate["params"], state


def test_five_steps_match_reference(five_steps):
    cfg, rlosses, losses, rparams, state = five_steps
    np.testing.assert_allclose(losses, rlosses, rtol=1e-3)
    assert int(state["opt"]["step"]) == STEPS
    if cfg.compute_dtype != "float32":
        return
    got = {n: p.detach().numpy() for n, p in state["params"].items()}
    for name, want in _flat(rparams).items():
        g = _per_layer(cfg, got, name) if name.startswith("layers.") \
            else got[name]
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_pruned_weights_are_zero_after_training(five_steps):
    cfg, _, _, _, state = five_steps
    p = state["params"]
    for i in range(cfg.n_layers):
        for w, m in (("wi_gate", "mask_in"), ("wi_up", "mask_in"),
                     ("wo", "mask_out")):
            mask = p[f"layers.{i}.ffn.{m}"]
            assert bool((p[f"layers.{i}.ffn.{w}"][mask == 0] == 0).all())
            assert bool((mask.sum(0) == 16).all())


def test_fixed_batch_memorisation():
    """The reference's system check (``tests/test_system.py``): 12 steps on
    one fixed batch at the default bfloat16 compute with
    ``LogicNetFFNCfg(fan_in=8, bw=3)`` lower the loss by at least 3 %
    (the reference's seed sweep read 5.6-6.3 %), and the masks hold."""
    cfg = dataclasses.replace(PC.get_smoke_config("qwen3-1.7b"),
                              logicnet_ffn=LogicNetFFNCfg(fan_in=8, bw=3,
                                                          max_val=4.0))
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    step = steps.make_train_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for _ in range(12):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.97
    w = state["params"]["layers.0.ffn.wi_gate"]
    m = state["params"]["layers.0.ffn.mask_in"]
    assert bool((w[m == 0] == 0).all())
    assert bool((m.sum(0) == 8).all())


def test_non_finite_step_leaves_the_state_bit_identical(ref_params):
    """The port's step updates in place, so a step whose loss is not finite
    must write nothing: every parameter, moment and the step count stay
    bit for bit."""
    _, cfg = _cfgs("bfloat16")
    state = _state(dict(_port_model(cfg, ref_params).named_parameters()))
    step = steps.make_train_step(cfg)
    state, _ = step(state, _torch_batch(_batch(cfg, 0)))
    with torch.no_grad():
        state["params"]["final_norm"][3] = float("nan")
    before = [t.detach().clone() for t in (
        *state["params"].values(), *state["opt"]["m"].values(),
        *state["opt"]["v"].values(), state["opt"]["step"])]
    state, loss = step(state, _torch_batch(_batch(cfg, 1)))
    assert not torch.isfinite(loss)
    after = [*state["params"].values(), *state["opt"]["m"].values(),
             *state["opt"]["v"].values(), state["opt"]["step"]]
    for a, b in zip(before, after):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.detach().view(torch.int32)
                           if b.is_floating_point() else b)
    assert int(state["opt"]["step"]) == 1


def test_train_loop_restart_resumes_bit_identically(tmp_path):
    """``launch.train``'s loop: 6 steps with a checkpoint every 3; the
    step-6 file removed (a failure before it was written), a fresh process
    restored at step 3 runs to 6: the same losses and the same state, bit
    for bit."""
    argv = ["--size", "smoke", "--device", "cpu", "--logicnet-ffn",
            "--steps", "6", "--seq", "32", "--global-batch", "4",
            "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    first = train.build(train.parse_args(argv))
    first.loop.run(first.batches, 6)
    (tmp_path / "step_00000006.npz").unlink()
    again = train.build(train.parse_args(argv + ["--resume"]))
    assert again.loop.step == 3
    again.loop.run(again.batches, 6)
    assert again.loop.metrics == first.loop.metrics[3:]
    a, b = first.loop.state, again.loop.state
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
        assert torch.equal(a["opt"]["m"][n], b["opt"]["m"][n]), n
        assert torch.equal(a["opt"]["v"][n], b["opt"]["v"][n]), n
    assert torch.equal(a["opt"]["step"], b["opt"]["step"])


# ---------------------------------------------------------------------------
# attention for training, abstract state, input specs, the CLIs
# ---------------------------------------------------------------------------

def test_flash_attention_refuses_inputs_that_require_grad():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == (1, 2, 8, 16)


def test_training_attention_matches_the_kernel_path():
    """``attn_apply(train=True)`` (the chunked attention, differentiable)
    computes what the flash path computes, in chunks of 16 keys over 48."""
    cfg = dataclasses.replace(PC.get_smoke_config("qwen3-1.7b"),
                              attn_chunk=16, compute_dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = A.attn_init(g, cfg)
    x = torch.randn((2, 48, cfg.d_model), generator=g)
    pos = torch.arange(48).expand(2, 48)
    want = A.attn_apply(p, cfg, x, pos, window=0)
    xg = x.clone().requires_grad_()
    got = A.attn_apply(p, cfg, xg, pos, window=0, train=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    got.sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    with pytest.raises(ValueError, match="no backward"):
        A.attn_apply(p, cfg, xg, pos, window=0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b"])
def test_abstract_params_match_the_reference(arch):
    cfg = PC.get_config(arch)
    rcfg = RC.get_config(arch)
    for logicnet in (False, True):
        if logicnet:
            cfg = dataclasses.replace(cfg, logicnet_ffn=LogicNetFFNCfg())
            rcfg = dataclasses.replace(rcfg,
                                       logicnet_ffn=RefLogicNetFFNCfg())
        got = steps.abstract_params(cfg)
        assert all(t.device.type == "meta" and t.dtype == torch.float32
                   for t in got.values())
        want = {".".join(k.key for k in path): leaf.shape for path, leaf in
                tree_flatten_with_path(RS.abstract_params(rcfg))[0]}
        for name, shape in want.items():
            if name.startswith("layers."):
                assert shape[0] == cfg.n_layers
                for i in range(cfg.n_layers):
                    assert tuple(got[name.replace(
                        "layers.", f"layers.{i}.", 1)].shape) == shape[1:]
            else:
                assert tuple(got[name].shape) == shape
        assert len(got) == sum(cfg.n_layers if n.startswith("layers.")
                               else 1 for n in want)
    state = steps.abstract_train_state(cfg)
    assert sorted(state["opt"]["m"]) == sorted(got)
    assert state["opt"]["step"].dtype == torch.int32


def test_abstract_params_are_the_init_names_and_shapes():
    _, cfg = _cfgs()
    got = {n: tuple(t.shape) for n, t in steps.abstract_params(cfg).items()}
    model = steps.init_params(cfg, seed=0, device="cpu")
    assert got == {n: tuple(p.shape) for n, p in model.named_parameters()}
    # one order, so AdamW sums the norm alike in a restored state
    assert list(steps.make_train_state(cfg, device="cpu")["params"]) == \
        list(got)


@pytest.mark.parametrize("shape", sorted(RC.SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b",
                                  "olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-2.7b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_input_specs_match_the_reference(arch, shape):
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    want = {jax.tree_util.keystr(p): (tuple(v.shape), str(np.dtype(v.dtype)))
            for p, v in tree_flatten_with_path(
                RS.input_specs(rcfg, RC.SHAPES[shape]))[0]}
    got = {}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        else:
            assert t.device.type == "meta"
            got[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))

    walk(steps.input_specs(cfg, PC.SHAPES[shape]))
    assert got == want


def test_entry_points_default_to_the_card():
    """Without a card, the new entry points raise unless the CPU is asked
    for by name."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        steps.make_train_state(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.main(["--size", "smoke", "--steps", "1"])


def test_train_and_serve_clis_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``launch.train`` prints the reference's ``[train]`` line and writes
    a checkpoint that ``serve_lm --ckpt-dir`` serves."""
    train.main(["--size", "smoke", "--device", "cpu", "--logicnet-ffn",
                "--steps", "4", "--seq", "32", "--global-batch", "2",
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] qwen3-1.7b-smoke: loss " in out and "(cpu)" in out
    monkeypatch.setattr(sys, "argv", ["serve_lm"])
    serve_lm.main(["--requests", "3", "--slots", "2", "--max-new", "4",
                   "--cache-len", "32", "--device", "cpu", "--logicnet-ffn",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"parameters of step 4 from {tmp_path}" in out
    assert "served 3 requests, 12 tokens" in out
    _, cfg = _cfgs("bfloat16")
    step, model = steps.restore_model(cfg, str(tmp_path), device="cpu")
    assert step == 4 and not any(p.requires_grad
                                 for p in model.parameters())
    with pytest.raises(FileNotFoundError):
        steps.restore_model(cfg, str(tmp_path / "none"), device="cpu")


# ---------------------------------------------------------------------------
# the MoE and SSM families: the loss with the aux term, its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b",
                                  "mamba2-370m", "zamba2-2.7b"])
def test_moe_ssm_loss_and_gradients_match_reference(arch):
    """``loss_fn`` at float32 (cross-entropy plus 0.01 x the MoE aux loss
    summed over layers, as the reference's), its global gradient norm
    (rtol 1e-5) and every leaf's gradient (atol 1e-6 / rtol 1e-4), from the
    reference's init carried in; a hybrid's shared layer gathers the
    gradient of all its sites."""
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               compute_dtype="float32")
    cfg = dataclasses.replace(PC.get_smoke_config(arch),
                              compute_dtype="float32")
    ref = RM.init_params(rcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (rloss, raux), rgrads = jax.jit(jax.value_and_grad(
        lambda p: (RM.loss_fn(p, rcfg, batch),
                   RM.forward(p, rcfg, batch)[1]), has_aux=True))(ref)
    model = M.from_reference(cfg, _flat(ref), device="cpu")
    params = _state(dict(model.named_parameters()))["params"]
    loss = M.loss_fn(params, cfg, _torch_batch(batch))
    _, aux = M.train_forward(params, cfg, _torch_batch(batch), with_aux=True)
    assert (float(raux) > 0) == (cfg.moe is not None)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    want = float(RA.global_norm(rgrads))
    assert abs(float(global_norm(grads.values())) - want) <= 1e-5 * want
    gflat = {n: g.numpy() for n, g in grads.items()}
    for name, g in _flat(rgrads).items():
        got_g = _per_layer(cfg, gflat, name) if name.split(".")[0] in (
            "layers", "ssm_layers") else gflat[name]
        np.testing.assert_allclose(got_g, g, atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_train_cli_runs_olmoe_smoke_on_the_cpu(tmp_path, capsys):
    """``launch.train --arch olmoe-1b-7b --size smoke --device cpu``: the
    loss the loop reads carries the aux term."""
    train.main(["--arch", "olmoe-1b-7b", "--size", "smoke", "--device",
                "cpu", "--steps", "3", "--seq", "32", "--global-batch", "2",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] olmoe-1b-7b-smoke: loss " in out and "(cpu)" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_remat_changes_no_number_in_the_new_families(arch):
    """``remat="full"`` over MoE layers, SSM layers and a hybrid's shared
    layer (checkpointed at each of its sites): the loss, aux term included,
    and every gradient equal the run without it bit for bit."""
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(PC.get_smoke_config(arch), remat=remat,
                                  compute_dtype="float32")
        params = steps.make_train_state(cfg, seed=0, device="cpu")["params"]
        batch = _torch_batch(_batch(cfg))
        loss = M.loss_fn(params, cfg, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(params.values())))
    assert torch.equal(out["none"][0], out["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1],
                                                 out["full"][1]))
