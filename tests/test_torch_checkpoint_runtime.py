"""The port's checkpoints, train loop and token stream against the
reference's contracts (``tests/test_checkpoint_runtime.py``), on the CPU.

Each contract of the reference's file has its counterpart here (round
trip, keep-k, async, shape mismatch, the restore hook, the loop's
checkpoints, exact restart, NaN guard, abort, the token stream), plus what
only the port can get wrong: a save snapshots by copy (an in-place update
after ``save`` returns must not reach the write in flight), dtypes numpy
cannot hold are refused, and a checkpoint of a plain dict tree written by
either package restores in the other.  ``TokenStream`` batches must equal
the reference's byte for byte.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro import checkpoint as RC
from repro.data import TokenStream as RefTokenStream
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import TokenStream
from repro_torch.runtime import TrainLoop, TrainLoopCfg


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 4), generator=g),
            "nested": {"b": torch.arange(6.0),
                       "step": torch.tensor(3, dtype=torch.int32)}}


def _equal_trees(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        np.testing.assert_array_equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(4, 4), "nested": {
        "b": torch.zeros(6), "step": torch.zeros((), dtype=torch.int32)}}
    _equal_trees(restore_checkpoint(str(tmp_path), 7, like), t)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    steps = sorted(int(f[5:13]) for f in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, _tree())
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    assert mgr._thread is None


def test_async_save_snapshots_by_copy(tmp_path, monkeypatch):
    """The write is held until the caller has updated its tensor in place
    (as the next AdamW step does): the checkpoint holds the values at
    ``save``, not the update."""
    release, started = threading.Event(), threading.Event()
    real = ckpt_mod.save_checkpoint

    def held(directory, step, tree):
        started.set()
        assert release.wait(timeout=30)
        return real(directory, step, tree)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", held)
    w = torch.arange(8.0)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"w": w})
    assert started.wait(timeout=30)
    w.add_(100.0)                       # the next step, in place
    release.set()
    mgr.wait()
    got = restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(8)})
    assert torch.equal(got["w"], torch.arange(8.0))


def test_async_write_error_raises_on_wait(tmp_path, monkeypatch):
    def broken(directory, step, tree):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", broken)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # reported once


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match=r"shape mismatch at \['a'\]"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros((3, 3))})


def test_restore_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match=r"\['b'\]"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2),
                                              "b": torch.zeros(2)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64, torch.bool])
def test_other_dtypes_are_refused(tmp_path, dtype):
    with pytest.raises(TypeError, match=r"\['w'\].*float32, int32 or int64"):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, dtype=dtype)})
    with pytest.raises(TypeError, match="float32, int32 or int64"):
        CheckpointManager(str(tmp_path)).save(1, {"w": torch.zeros(
            2, dtype=dtype)})


def test_elastic_restore_hook(tmp_path):
    """``map_fn(path, array)`` is called per leaf (the reference's
    ``sharding_fn``); what it returns is the leaf, None keeps the default."""
    t = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(3)}
    save_checkpoint(str(tmp_path), 1, t)
    calls = []

    def map_fn(path, arr):
        calls.append((path, arr.shape))
        return torch.from_numpy(arr) * 2 if path == "['w']" else None

    got = restore_checkpoint(str(tmp_path), 1, t, map_fn=map_fn)
    assert sorted(calls) == [("['b']", (3,)), ("['w']", (4, 4))]
    assert torch.equal(got["w"], t["w"] * 2)
    assert torch.equal(got["b"], t["b"])


def test_restore_onto_a_meta_tree_keeps_dtype_and_grad(tmp_path):
    """A ``meta`` tree (``launch.steps.abstract_train_state``) restores onto
    a device without a state allocated there first; a leaf comes back with
    its ``like``'s dtype and ``requires_grad``."""
    save_checkpoint(str(tmp_path), 2, {"p": torch.arange(4.0),
                                       "s": torch.tensor(5,
                                                         dtype=torch.int32)})
    like = {"p": torch.empty(4, device="meta").requires_grad_(),
            "s": torch.empty((), dtype=torch.int32, device="meta")}
    got = restore_checkpoint(str(tmp_path), 2, like, device="cpu")
    assert got["p"].device.type == "cpu" and got["p"].requires_grad
    assert torch.equal(got["p"].detach(), torch.arange(4.0))
    assert got["s"].dtype == torch.int32 and int(got["s"]) == 5


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A plain dict tree: the same ``keystr`` paths, so either package's
    ``restore_checkpoint`` reads the other's file."""
    t = _tree(1)
    save_checkpoint(str(tmp_path), 4, t)
    like = {"a": jnp.zeros((4, 4)), "nested": {
        "b": jnp.zeros(6), "step": jnp.zeros((), jnp.int32)}}
    got = RC.restore_checkpoint(str(tmp_path), 4, like)
    np.testing.assert_array_equal(np.asarray(got["a"]), t["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["nested"]["b"]),
                                  t["nested"]["b"].numpy())
    assert int(got["nested"]["step"]) == 3
    assert RC.latest_step(str(tmp_path)) == 4


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(3)
    t = {"state": {"params": {"embed": {"tok": jnp.asarray(
        rng.standard_normal((5, 3)).astype(np.float32))}},
        "opt": {"step": jnp.asarray(7, jnp.int32)}},
        "step": np.asarray(11)}
    RC.save_checkpoint(str(tmp_path), 11, t)
    like = {"state": {"params": {"embed": {"tok": torch.zeros(5, 3)}},
                      "opt": {"step": torch.zeros((), dtype=torch.int32)}},
            "step": np.asarray(0)}
    got = restore_checkpoint(str(tmp_path), 11, like)
    np.testing.assert_array_equal(
        got["state"]["params"]["embed"]["tok"].numpy(),
        np.asarray(t["state"]["params"]["embed"]["tok"]))
    assert int(got["state"]["opt"]["step"]) == 7 and int(got["step"]) == 11
    assert isinstance(got["step"], np.ndarray)


# ---------------------------------------------------------------------------
# TrainLoop
# ---------------------------------------------------------------------------

def _sgd_loop(tmp_path, n_steps=10, ckpt_every=4, poison_step=None):
    """The reference's SGD loop in the port's idiom: the step updates the
    state in place, and leaves it untouched when its loss is not finite."""
    def step_fn(state, batch):
        w = state["w"]
        loss = torch.sum((w - batch["target"]) ** 2)
        if poison_step is not None and batch["step"] == poison_step:
            loss = loss * float("nan")
        if torch.isfinite(loss):
            w.sub_(0.1 * 2 * (w - batch["target"]))
        return state, loss

    def batches(step):
        return {"target": torch.ones(3), "step": step}

    loop = TrainLoop(TrainLoopCfg(ckpt_dir=str(tmp_path),
                                  ckpt_every=ckpt_every, async_save=False),
                     step_fn, {"w": torch.zeros(3)})
    return loop, batches


def test_loop_runs_and_checkpoints(tmp_path):
    loop, batches = _sgd_loop(tmp_path)
    loop.run(batches, 10)
    assert latest_step(str(tmp_path)) == 8
    assert len(loop.metrics) == 10


def test_loop_restart_resumes_exactly(tmp_path):
    loop, batches = _sgd_loop(tmp_path)
    loop.run(batches, 10)
    w_ref = loop.state["w"].clone()

    # a node failure at step 10: a new process restores at 8
    loop2, batches2 = _sgd_loop(tmp_path)
    assert loop2.try_restore()
    assert loop2.step == 8
    loop2.run(batches2, 10)
    assert torch.equal(loop2.state["w"], w_ref)


def test_loop_nan_guard_skips_bad_step(tmp_path):
    loop, batches = _sgd_loop(tmp_path, poison_step=3)
    seen = {}
    step_fn = loop.step_fn

    def watched(state, batch):
        before = state["w"].clone()
        out = step_fn(state, batch)
        seen[batch["step"]] = torch.equal(state["w"], before)
        return out

    loop.step_fn = watched
    loop.run(batches, 6)
    assert len(loop.metrics) == 5            # step 3 skipped
    assert 3 not in [s for s, _ in loop.metrics]
    assert seen[3] and not seen[2]           # the bad step wrote nothing
    assert loop.bad_steps == 0 and torch.isfinite(loop.state["w"]).all()


def test_loop_aborts_after_max_bad_steps(tmp_path):
    def step_fn(state, batch):
        return state, torch.tensor(float("nan"))

    loop = TrainLoop(TrainLoopCfg(ckpt_dir=str(tmp_path), max_bad_steps=3,
                                  async_save=False),
                     step_fn, {"w": torch.zeros(1)})
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        loop.run(lambda s: {}, 100)
    assert loop.step == 2 and not loop.metrics


def test_try_restore_without_checkpoint(tmp_path):
    loop, _ = _sgd_loop(tmp_path / "empty")
    assert not loop.try_restore()
    assert loop.step == 0


# ---------------------------------------------------------------------------
# Data pipeline: byte for byte the reference's, determinism, host sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (100, 16, 8, 1, 2), (151936, 256, 8, 0, 1), (256, 64, 4, 3, 4)])
def test_token_stream_equals_reference(vocab, seq, batch, seed, hosts):
    for host in range(hosts):
        port = TokenStream(vocab, seq, batch, seed, hosts, host)
        ref = RefTokenStream(vocab, seq, batch, seed, hosts, host)
        assert port.local_batch == ref.local_batch
        for step in (0, 1, 6, 7, 100):
            got, want = port.batch(step), ref.batch(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].tobytes() == want[k].tobytes()


def test_token_stream_deterministic_and_host_sharded():
    a = TokenStream(vocab=100, seq_len=16, global_batch=8, seed=1,
                    n_hosts=2, host=0)
    b = TokenStream(vocab=100, seq_len=16, global_batch=8, seed=1,
                    n_hosts=2, host=1)
    a2 = TokenStream(vocab=100, seq_len=16, global_batch=8, seed=1,
                     n_hosts=2, host=0)
    ba, bb = a.batch(5), b.batch(5)
    np.testing.assert_array_equal(ba["tokens"], a2.batch(5)["tokens"])
    assert not np.array_equal(ba["tokens"], bb["tokens"])
    assert ba["tokens"].shape == (4, 16)
    assert ba["tokens"].max() < 100
    # labels are next-token shifted
    np.testing.assert_array_equal(ba["labels"][:, :-1], ba["tokens"][:, 1:])
    with pytest.raises(ValueError, match="does not split"):
        TokenStream(vocab=100, seq_len=16, global_batch=7, n_hosts=2)
