"""Training every LM arch of the zoo against the reference's, on the CPU.

The reference's training record, ``tests/fixtures/torch_port/
lm_smoke_train.npz`` (``tools/make_torch_fixture.py --only lm_train``),
holds five AdamW steps (lr 3e-4, weight decay 0.01, ``cosine_schedule(1,
5)``) of ``repro.launch.steps.make_train_step`` for every arch of the zoo
at its smoke config, and with ``LogicNetFFNCfg()`` for qwen3-1.7b,
zamba2-2.7b (the shared attention block, 4 sites at smoke size) and
qwen2-vl-2b, at float32 and bfloat16 compute, from ``init_params`` at
PRNGKey(0) on ``TokenStream(seed=0)`` batches of 4 x 64 with zero
``frames`` / ``vision_embeds``.  The port's side runs through
``chip_smoke.py``'s phase-17a helpers (``train_five_steps``), which carry
the reference's init in with ``from_reference``; the gates are phase 17a's:

* the five losses within rtol 1e-3 at either compute dtype;
* the step-0 global gradient norm, mask gradients included and a hybrid's
  shared leaves counted once (their gradient summed over sites), within
  rtol 1e-5 at float32 and 0.05 at bfloat16;
* at float32 the final parameters within atol 1e-5.  AdamW's first move of
  an element is lr * g / (|g| + 1e-8): where the clipped step-0 gradient
  |g| is not 0 but below 1e-7 that move follows g's own float32 rounding
  (on this record qwen3-1.7b misses 1e-5 by it at 1 of 90 496 elements,
  1.02e-5, and zamba2-2.7b at 1 of 170 144, 7.47e-5), so those elements,
  under 1 % of each run's, are held to two first-step moves, 6e-4;
* after the steps a LogicNet run's pruned weights are 0 and each mask
  column sums to its fan-in;
* a MoE run at bfloat16 (capacity E / k, as the record's) sets aside the
  first step whose expert sets differ from the record's (a near-tie that
  one bfloat16 step of noise settles either way) and the steps after it:
  a reading past its gate there is not a failure, as
  ``chip_smoke.lm_check_routes`` takes positions; float32 holds every
  step, and takes the reference's experts at every position.

Besides: the LogicNet-FFN masks of zamba2's shared block and of qwen2-vl
equal the reference's bit for bit; AdamW decays the leaves the reference
decays (rank >= 2 on its stacked pytree); a 2 + 2-step save-and-resume of
an arch of each family equals 4 uninterrupted steps bit for bit; and the
committed record equals a fresh generation, run by run.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from torch_port_util import FIXTURE_DIR, ROOT, one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.launch import steps as RS
from repro.models import model as RM
from repro.models.config import LogicNetFFNCfg as RefLogicNetFFNCfg
from repro_torch import configs as PC
from repro_torch.launch import steps, train
from repro_torch.models import model as M
from repro_torch.models.config import LogicNetFFNCfg

CPU = torch.device("cpu")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load("chip_smoke_train", Path(ROOT) / "chip_smoke.py")
RUNS = CS.train_runs()
CASES = [(run, dtype) for run, _, _ in RUNS
         for dtype in ("float32", "bfloat16")]
ARCH = {run: (arch, logicnet) for run, arch, logicnet in RUNS}


@pytest.fixture(scope="module")
def fx():
    return CS.train_record()


_DONE: dict = {}


@pytest.fixture(scope="module")
def port_run(fx):
    """``(cfg, the port's readings)`` of a run, each run computed once."""
    def get(run, dtype):
        if (run, dtype) not in _DONE:
            arch, logicnet = ARCH[run]
            cfg = CS.train_config(arch, logicnet, dtype,
                                  fx.get(f"{run}.{dtype}.capacity_factor"))
            with torch.random.fork_rng():
                got = CS.train_five_steps(torch, cfg,
                                          CS.train_arrays(fx, run), CPU)
            _DONE[(run, dtype)] = (cfg, got)
        return _DONE[(run, dtype)]
    return get


def _aside(fx, run, dtype, got):
    """At bfloat16, the first step whose expert sets differ from the
    record's (it and the steps after it are set aside), else None."""
    if got["routes"] is None or dtype == "float32":
        return None
    return CS.first_differing_step(got["routes"],
                                   fx[f"{run}.{dtype}.topi"])


# ---------------------------------------------------------------------------
# five AdamW steps against the reference's record
# ---------------------------------------------------------------------------

def _tool():
    return _load("make_torch_fixture",
                 Path(ROOT) / "tools" / "make_torch_fixture.py")


def test_the_record_covers_every_arch_of_the_zoo(fx):
    """Every zoo arch and the three LogicNet runs; ``chip_smoke.py``'s
    copy of the record's runs, hyperparameters and init sources equals
    the tool's (the script imports nothing of the tool)."""
    tool = _tool()
    assert sorted(CS.FT_ARCHS) == sorted(RC.ARCH_IDS)
    assert len(RUNS) == 13 and RUNS == tool.train_runs()
    assert (CS.FT_STEPS, CS.FT_BATCH, CS.FT_SEQ, CS.FT_LR, CS.FT_DECAY) == (
        tool.LM_TRAIN_STEPS, tool.LM_TRAIN_BATCH, tool.LM_SEQ,
        tool.LM_TRAIN_LR, tool.LM_TRAIN_DECAY)
    assert CS.INIT_FIXTURES == {
        tool.LM_NAME: tool.LM_ARCHS, tool.LM_MOE_SSM_NAME:
        tool.LM_MOE_SSM_ARCHS, tool.LM_ENCDEC_VLM_NAME:
        tool.LM_ENCDEC_VLM_ARCHS}
    assert CS.TRAIN_RECORD == tool.LM_TRAIN_NAME
    for run, dtype in CASES:
        assert fx[f"{run}.{dtype}.losses"].shape == (CS.FT_STEPS,)


@pytest.mark.parametrize("run,dtype", CASES)
def test_losses_match_the_reference(fx, port_run, run, dtype):
    _, got = port_run(run, dtype)
    want = fx[f"{run}.{dtype}.losses"]
    rtol = np.abs(np.asarray(got["losses"]) - want) / want
    assert CS.unexplained_steps(rtol, CS.FT_LOSS_RTOL,
                                _aside(fx, run, dtype, got)) == []
    assert np.isfinite(got["losses"]).all()


@pytest.mark.parametrize("run,dtype", CASES)
def test_step0_gradient_norm_matches_the_reference(fx, port_run, run,
                                                   dtype):
    _, got = port_run(run, dtype)
    want = float(fx[f"{run}.{dtype}.grad_norm0"])
    rtol = abs(got["grad_norm0"] - want) / want
    assert CS.unexplained_steps([rtol], CS.FT_NORM_RTOL[dtype],
                                _aside(fx, run, dtype, got)) == []


@pytest.mark.parametrize("run", [run for run, _, _ in RUNS])
def test_final_float32_parameters_match_the_reference(fx, port_run, run):
    cfg, got = port_run(run, "float32")
    base = CS.masked_init(CS.train_arrays(fx, run))
    pre = f"{run}.float32.delta."
    names = [k[len(pre):] for k in fx if k.startswith(pre)]
    assert sorted(names) == sorted(n for n in M.reference_names(cfg)
                                   if "mask" not in n)
    conditioned = elements = 0
    for name in names:
        want = base[name] + fx[pre + name].astype(np.float32)
        mine = CS.stacked_port(cfg, got["params"], name)
        cond = CS.stacked_port(cfg, {n: c.float() for n, c in
                                     got["conditioned"].items()},
                               name).astype(bool)
        diff = np.abs(mine - want)
        assert diff[~cond].max(initial=0.0) <= CS.FT_PARAM_ATOL, name
        assert diff[cond].max(initial=0.0) <= CS.FT_CONDITIONED_ATOL, name
        conditioned += int(cond.sum())
        elements += cond.size
    # 17-817 elements a run on this record, under 1 %
    assert conditioned < elements // 100


@pytest.mark.parametrize("run,dtype", [c for c in CASES
                                       if ARCH[c[0]][1]])
def test_masks_hold_after_training(port_run, run, dtype):
    """Every pruned weight of each LogicNet-FFN (zamba2's shared block:
    one set of masks for all its sites) is 0 and each mask column sums to
    the fan-in, 16."""
    cfg, got = port_run(run, dtype)
    assert CS.pruned_and_fan_in(got["params"], cfg.logicnet_ffn.fan_in) == []
    masks = [n for n in got["params"] if "mask" in n]
    assert len(masks) == 2 * (1 if cfg.is_hybrid else cfg.n_layers)


@pytest.mark.parametrize("run,dtype", [c for c in CASES
                                       if ARCH[c[0]][0] in
                                       ("olmoe-1b-7b",
                                        "qwen3-moe-235b-a22b")])
def test_moe_router_choices_follow_the_reference(fx, port_run, run, dtype):
    """float32 takes the reference's experts at every position of every
    step; at bfloat16 a near-tie may settle the other way, at a few of the
    256 positions a step (3-8 on this record)."""
    _, got = port_run(run, dtype)
    topi = fx[f"{run}.{dtype}.topi"]
    differ = [int(CS.routes_differ(sets, CS.fixture_route_sets(
        topi[i])).sum()) for i, sets in enumerate(got["routes"])]
    if dtype == "float32":
        assert differ == [0] * CS.FT_STEPS
    else:
        assert max(differ) < CS.FT_BATCH * CS.FT_SEQ // 10


@pytest.mark.parametrize("run,dtype", CASES)
def test_chip_smoke_gates_pass_on_the_cpu(fx, port_run, run, dtype):
    """Phase 17a's gate function takes the port's CPU run."""
    cfg, got = port_run(run, dtype)
    rec = CS.train_check(run, dtype, cfg, got, fx)
    assert rec["loss_rtol"] <= CS.FT_LOSS_RTOL
    assert ("param_err" in rec) == (dtype == "float32")


@pytest.mark.parametrize("d_model,d_ff", [(1536, 8960), (2560, 10240)])
def test_logicnet_ffn_at_the_full_widths_matches_the_reference(d_model,
                                                               d_ff):
    """qwen2-vl-2b's (1536 x 8960) and zamba2-2.7b's (2560 x 10240)
    LogicNet-FFN on 6 rows: the masks bit for bit, and at float32 the
    output and the gradients of the input, the weights and the masks
    against the reference's (the plain masked products on the CPU; the
    card's kernel at these shapes is phase 17c's)."""
    import jax.numpy as jnp

    from repro.core.sparsity import apriori_mask as ref_mask
    from repro.models import layers as RL
    from repro_torch.models import layers as L
    cfg = LogicNetFFNCfg()
    mask_in, mask_out = L.logicnet_masks(d_model, d_ff, cfg)
    np.testing.assert_array_equal(mask_in.numpy(), np.asarray(
        ref_mask(0, d_model, d_ff, 16)))
    np.testing.assert_array_equal(mask_out.numpy(), np.asarray(
        ref_mask(1, d_ff, d_model, 16)))
    rng = np.random.default_rng(7)
    p = {"wi_gate": rng.standard_normal((d_model, d_ff)) * 0.5,
         "wi_up": rng.standard_normal((d_model, d_ff)) * 0.5,
         "wo": rng.standard_normal((d_ff, d_model)) * 0.5,
         "mask_in": mask_in.numpy(), "mask_out": mask_out.numpy()}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = (rng.standard_normal((2, 3, d_model)) * 2).astype(np.float32)
    dy = rng.standard_normal((2, 3, d_model)).astype(np.float32)
    out, vjp = jax.vjp(lambda pp, xx: RL.logicnet_ffn_apply(
        pp, xx, RefLogicNetFFNCfg()), {k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = L.logicnet_ffn_apply(tp, tx, cfg)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x),
                               atol=1e-4, rtol=1e-4)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(want_p[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_whisper_training_through_a_ragged_chunk_matches_the_reference():
    """At ``attn_chunk`` 12 the smoke config's 16 frames and 64 tokens
    both end in a ragged chunk, which the reference's chunked attention
    clamps (ROADMAP §3): the port's training path keeps the clamp, so the
    float32 loss (rtol 1e-6), the global gradient norm (1e-5) and every
    leaf's gradient (atol 1e-6 / rtol 1e-4) equal the reference's, as
    whisper-medium's 1500 frames at ``attn_chunk`` 1024 do at full
    width."""
    from repro.optim import adamw as RA
    from repro_torch.optim import global_norm
    arch = "whisper-medium"
    rcfg = dataclasses.replace(RC.get_smoke_config(arch), attn_chunk=12,
                               compute_dtype="float32")
    cfg = dataclasses.replace(PC.get_smoke_config(arch), attn_chunk=12,
                              compute_dtype="float32")
    ref = RM.init_params(rcfg, jax.random.PRNGKey(0))
    batch = CS.train_batch(torch, cfg, 0, CPU)
    rbatch = {k: jax.numpy.asarray(v.float().numpy() if v.is_floating_point()
                                   else v.numpy()) for k, v in batch.items()}
    rbatch["frames"] = rbatch["frames"].astype(jax.numpy.bfloat16)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, rbatch)))(ref)
    flat = {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(ref)[0]}
    params = {n: t.detach().clone().requires_grad_() for n, t in
              M.from_reference(cfg, flat, device="cpu").params.items()}
    loss = M.loss_fn(params, cfg, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    want = float(RA.global_norm(rgrads))
    assert abs(float(global_norm(grads.values())) - want) <= 1e-5 * want
    for name, g in ((".".join(k.key for k in path), np.asarray(leaf))
                    for path, leaf in tree_flatten_with_path(rgrads)[0]):
        np.testing.assert_allclose(CS.stacked_port(cfg, grads, name), g,
                                   atol=1e-6, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# masks, weight decay, save and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-vl-2b"])
def test_logicnet_masks_equal_the_reference_bit_for_bit(arch):
    """The port's own init draws the reference's masks: zamba2's shared
    block (one layer's, unstacked) and every qwen2-vl layer's."""
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               logicnet_ffn=RefLogicNetFFNCfg())
    cfg = dataclasses.replace(PC.get_smoke_config(arch),
                              logicnet_ffn=LogicNetFFNCfg())
    ref = RM.init_params(rcfg, jax.random.PRNGKey(0))
    got = {n: p.numpy() for n, p in steps.init_params(
        cfg, seed=3, device="cpu").params.items()}
    for leaf in ("mask_in", "mask_out"):
        if cfg.is_hybrid:
            want = np.asarray(ref["shared_attn"]["ffn"][leaf])
            np.testing.assert_array_equal(got[f"shared_attn.ffn.{leaf}"],
                                          want)
        else:
            want = np.asarray(ref["layers"]["ffn"][leaf])
            np.testing.assert_array_equal(
                np.stack([got[f"layers.{i}.ffn.{leaf}"]
                          for i in range(cfg.n_layers)]), want)
        assert (want.sum(axis=-2) == 16).all()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "whisper-medium", "qwen2-vl-2b"])
def test_weight_decay_follows_the_references_leaves(arch):
    """AdamW decays a leaf of rank >= 2.  The reference stacks each list's
    layers, so a layer's norms and an SSM's ``a_log``, ``d_skip`` and
    ``dt_bias`` decay there; a hybrid's shared layer is one layer's, so
    its norms do not.  ``launch.steps.decays`` reads the rank on the
    reference's leaves."""
    cfg = dataclasses.replace(PC.get_smoke_config(arch),
                              logicnet_ffn=LogicNetFFNCfg())
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               logicnet_ffn=RefLogicNetFFNCfg())
    ref = {".".join(k.key for k in path): leaf.ndim >= 2 for path, leaf in
           tree_flatten_with_path(RS.abstract_params(rcfg))[0]}
    got = {}
    for name, p in steps.abstract_params(cfg).items():
        stack, _, rest = name.partition(".")
        key = (f"{stack}.{rest.partition('.')[2]}" if stack in M._STACKED
               else name)
        got.setdefault(key, set()).add(steps.decays(name, p))
    assert got == {k: {v} for k, v in ref.items()}


@pytest.mark.parametrize("arch,logicnet", [
    ("olmoe-1b-7b", False), ("mamba2-370m", False), ("zamba2-2.7b", True),
    ("whisper-medium", False), ("qwen2-vl-2b", True)])
def test_save_and_resume_is_bit_identical(tmp_path, arch, logicnet):
    """``launch.train``'s loop: 2 steps and a checkpoint, then a fresh
    process restored from it (``--resume``, its state described on the
    meta device) runs steps 3-4: losses and the whole state equal 4
    uninterrupted steps bit for bit."""
    def argv(d, every):
        return (["--arch", arch, "--size", "smoke", "--device", "cpu",
                 "--steps", "4", "--seq", "32", "--global-batch", "2",
                 "--ckpt-every", str(every), "--ckpt-dir", str(d)]
                + ["--logicnet-ffn"] * logicnet)
    whole = train.build(train.parse_args(argv(tmp_path / "whole", 100)))
    whole.loop.run(whole.batches, 4)
    first = train.build(train.parse_args(argv(tmp_path / "cut", 2)))
    first.loop.run(first.batches, 2)
    first.loop.mgr.wait()
    again = train.build(train.parse_args(argv(tmp_path / "cut", 2)
                                         + ["--resume"]))
    assert again.loop.step == 2
    again.loop.run(again.batches, 4)
    assert (first.loop.metrics + again.loop.metrics
            == whole.loop.metrics)
    a, b = whole.loop.state, again.loop.state
    assert list(a["params"]) == list(b["params"])
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
        assert torch.equal(a["opt"]["m"][n], b["opt"]["m"][n]), n
        assert torch.equal(a["opt"]["v"][n], b["opt"]["v"][n]), n
    assert torch.equal(a["opt"]["step"], b["opt"]["step"])


def test_a_zero_row_amplifies_the_gradient_as_in_the_reference():
    """Reference behaviour the port reproduces: rms_norm's Jacobian at an
    all-zero row is (1 + scale) / sqrt(eps), 1000-fold at eps 1e-6.  The
    launcher's zero vision embeddings keep qwen2-vl's 256 vision rows at
    0 through every layer, so their gradient grows about that much a
    layer back: at 28 layers it overflows in both packages (ROADMAP §3),
    and ``chip_smoke.py``'s full-width run feeds seeded embeddings."""
    import jax.numpy as jnp

    from repro.models import layers as RL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    x = np.zeros((2, 3, 8), np.float32)
    x[1, 2] = rng.standard_normal(8)
    scale = (rng.standard_normal(8) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, 3, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: RL.rms_norm(a, jnp.asarray(scale), 1e-6),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = torch.from_numpy(x).requires_grad_()
    L.rms_norm(xt, torch.from_numpy(scale), 1e-6).backward(
        torch.from_numpy(dy))
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    zero = (x == 0).all(-1)
    np.testing.assert_allclose(got[zero], (dy * (1 + scale) / 1e-3)[zero],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the record against a fresh generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", [run for run, _, _ in RUNS])
def test_train_record_matches_fresh_reference_generation(fx, run):
    """Regenerate a run of ``lm_smoke_train.npz`` with the reference: the
    committed arrays of that run equal it array for array."""
    tool = _tool()
    fresh = tool.build_lm_train(runs=[run])
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_TRAIN_NAME)) as z:
        committed = {k: z[k] for k in z.files
                     if k.startswith(f"{run}.")}
    assert fresh.keys() == committed.keys()
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype, k
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
