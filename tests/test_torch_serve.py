"""The port's micro-batching tier (``repro_torch.serve``), on the CPU.

The contracts of ``tests/test_serve.py``, held by the port serving the
model A level-3 artifact that the reference compiled: coalesced outputs
bit-exact (tolerance 0: integer codes) with calling the artifact
directly, size / deadline / drain flushes, backpressure, launch
timeouts, prompt empty-queue shutdown, and a steady state with zero
kernel builds and zero compiler runs after warmup; plus the load
generators and the ``python -m repro_torch.launch.serve`` CLI.
"""

import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_port_util import (ARTIFACT, SRC, codes,  # noqa: F401
                             one_torch_thread)

from repro import engine as jengine
from repro_torch import engine, serve


@pytest.fixture(scope="module")
def net():
    return engine.load(ARTIFACT, device="cpu")


def _requests(net, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 8, (int(k), net.n_in), dtype=np.int32)
            for k in sizes]


def test_coalescing_bit_exact_and_zero_rebuilds(net):
    sizes = np.random.default_rng(1).integers(1, 7, 40)
    reqs = _requests(net, sizes, seed=2)

    async def main():
        cfg = serve.TierConfig(max_batch_rows=32, flush_deadline_s=0.002)
        async with serve.ServingTier(net, cfg) as tier:
            outs = await asyncio.gather(*[tier.infer(r) for r in reqs])
            return outs, tier.stats()

    outs, stats = asyncio.run(main())
    for r, o in zip(reqs, outs):
        assert o.dtype == np.int32
        np.testing.assert_array_equal(o, net(r).numpy())
    assert stats["batches"] < stats["requests"], "no coalescing happened"
    assert stats["retraces_after_warmup"] == 0
    assert stats["compiler_runs_after_warmup"] == 0
    assert stats["rows"] == int(sizes.sum())
    assert 0.0 < stats["batch_occupancy"] <= 1.0
    assert stats["flush_causes"]["size"] >= 1
    assert stats["n_devices"] == 1 and not stats["sharded"]


def test_outputs_match_reference_engine(net):
    """Served through the port's tier == the reference engine's outputs on
    the same artifact."""
    reqs = _requests(net, [3, 5, 1], seed=7)
    outs = serve.run_requests(net, reqs)
    jnet = jengine.load(ARTIFACT)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, np.asarray(jnet(r)))


def test_single_row_and_empty_and_validation(net):
    async def main():
        async with serve.ServingTier(net) as tier:
            single = await tier.infer(np.zeros((net.n_in,), np.int32))
            empty = await tier.infer(np.zeros((0, net.n_in), np.int32))
            with pytest.raises(ValueError, match="expected"):
                await tier.infer(np.zeros((2, net.n_in + 1), np.int32))
            return single, empty

    single, empty = asyncio.run(main())
    assert single.shape == (net.n_out,)
    np.testing.assert_array_equal(
        single, net(np.zeros((1, net.n_in), np.int32)).numpy()[0])
    assert empty.shape == (0, net.n_out) and empty.dtype == np.int32


def test_deadline_flush_under_light_load(net):
    req = _requests(net, [3], seed=3)[0]

    async def main():
        cfg = serve.TierConfig(max_batch_rows=64, flush_deadline_s=0.05)
        async with serve.ServingTier(net, cfg) as tier:
            t0 = time.perf_counter()
            out = await tier.infer(req)
            return out, time.perf_counter() - t0, tier.stats()

    out, dt, stats = asyncio.run(main())
    np.testing.assert_array_equal(out, net(req).numpy())
    assert dt >= 0.04, "flushed before the deadline window"
    assert stats["flush_causes"]["deadline"] == 1
    assert stats["flush_causes"]["size"] == 0


def _slow_net(net, delay_s):
    """The artifact with every batch taking at least ``delay_s``."""

    class Slow:
        n_in, n_out, block_b, device = (net.n_in, net.n_out, net.block_b,
                                        net.device)

        def __call__(self, x):
            time.sleep(delay_s)
            return net(x)

        def kernel_builds(self):
            return net.kernel_builds()

    return Slow()


def test_backpressure_rejects_when_queue_full(net):
    slow = _slow_net(net, 0.2)

    async def main():
        cfg = serve.TierConfig(max_batch_rows=4, flush_deadline_s=0.0,
                               max_queue_rows=8, warmup=False)
        async with serve.ServingTier(slow, cfg) as tier:
            first = asyncio.ensure_future(
                tier.infer(np.zeros((4, net.n_in), np.int32)))
            await asyncio.sleep(0.05)
            q1 = asyncio.ensure_future(
                tier.infer(np.zeros((8, net.n_in), np.int32)))
            await asyncio.sleep(0)
            with pytest.raises(serve.TierOverloaded):
                await tier.infer(np.zeros((1, net.n_in), np.int32))
            stats_mid = tier.stats()
            out0, out1 = await first, await q1
            return out0, out1, stats_mid, tier.stats()

    out0, out1, stats_mid, stats = asyncio.run(main())
    assert stats_mid["rejected"] == 1
    assert out0.shape == (4, net.n_out) and out1.shape == (8, net.n_out)
    assert stats["queued_rows"] == 0


def test_request_timeout_before_launch(net):
    slow = _slow_net(net, 0.25)

    async def main():
        cfg = serve.TierConfig(max_batch_rows=2, flush_deadline_s=0.0,
                               request_timeout_s=0.1, warmup=False)
        async with serve.ServingTier(slow, cfg) as tier:
            first = asyncio.ensure_future(
                tier.infer(np.zeros((2, net.n_in), np.int32)))
            await asyncio.sleep(0.05)
            with pytest.raises(serve.RequestTimeout):
                await tier.infer(np.zeros((1, net.n_in), np.int32))
            return await first, tier.stats()

    out0, stats = asyncio.run(main())
    assert out0.shape == (2, net.n_out)
    assert stats["timed_out"] == 1


def test_empty_queue_shutdown_is_prompt(net):
    async def main():
        tier = serve.ServingTier(net, serve.TierConfig(warmup=False))
        await tier.start()
        t0 = time.perf_counter()
        await tier.stop()
        dt = time.perf_counter() - t0
        with pytest.raises(serve.TierClosed):
            await tier.infer(np.zeros((1, net.n_in), np.int32))
        return dt

    assert asyncio.run(main()) < 1.0


def test_drain_flush_on_shutdown(net):
    req = _requests(net, [5], seed=4)[0]

    async def main():
        cfg = serve.TierConfig(max_batch_rows=64, flush_deadline_s=5.0)
        tier = await serve.ServingTier(net, cfg).start()
        fut = asyncio.ensure_future(tier.infer(req))
        await asyncio.sleep(0.02)
        await tier.stop()
        return await fut, tier.stats()

    out, stats = asyncio.run(main())
    np.testing.assert_array_equal(out, net(req).numpy())
    assert stats["flush_causes"]["drain"] == 1


def test_double_start_rejected_and_oversized_request(net):
    req = _requests(net, [40], seed=6)[0]

    async def main():
        cfg = serve.TierConfig(max_batch_rows=16, flush_deadline_s=0.001)
        tier = await serve.ServingTier(net, cfg).start()
        with pytest.raises(serve.TierError, match="already started"):
            await tier.start()
        out = await tier.infer(req)
        await tier.stop()
        return out, tier.stats()

    out, stats = asyncio.run(main())
    np.testing.assert_array_equal(out, net(req).numpy())
    assert stats["batches"] == 1 and stats["rows"] == 40


def test_load_generators(net):
    rep = serve.run_closed_loop(net, n_clients=2, n_per_client=3,
                                rows_max=3, bw=3, seed=1)
    assert rep.n_requests == 6 and (rep.rejected, rep.timed_out) == (0, 0)
    assert rep.stats["retraces_after_warmup"] == 0
    assert rep.breakdown["total"]["count"] == 6
    rep = serve.run_open_loop(net, offered_rps=500.0, n_requests=8,
                              rows_max=3, bw=3, seed=2)
    assert rep.outcomes == {"ok": 8} and rep.rejection_rate == 0.0
    assert serve.poisson_arrivals(100.0, 4, seed=2).shape == (4,)
    reqs = serve.make_requests(16, 5, rows_min=2, rows_max=4, bw=3, seed=0)
    assert all(2 <= r.shape[0] <= 4 and r.max() < 8 for r in reqs)


@pytest.mark.parametrize("n_dev", [4])
def test_multi_device_sharded_serving(n_dev):
    """``tests/test_serve.py``'s sharded tier on the port: four CPU
    replicas (torch has no multi-device CPU, so the device repeats; the
    first entry serves the artifact itself, the others copies the engine
    loaded), each padded batch split into four row shards.  Outputs stay
    bit-exact with ``net(codes)`` and the reference engine's, and the
    steady state builds and compiles nothing."""
    rng = np.random.default_rng(0)
    layers = []
    for a, b in zip((12, 20, 16), (20, 16, 8)):
        idx = np.stack([np.sort(rng.choice(a, 3, replace=False))
                        for _ in range(b)]).astype(np.int32)
        tab = rng.integers(0, 4, (b, 2 ** 6), dtype=np.int32)
        layers.append((idx, tab, 2))
    net = engine.compile_network(layers, optimize_level=3, in_features=12,
                                 block_b=8, device="cpu")
    jnet = jengine.compile_network(layers, optimize_level=3, in_features=12,
                                   block_b=8)
    reqs = [rng.integers(0, 4, (int(k), 12), dtype=np.int32)
            for k in rng.integers(1, 7, 30)]

    async def main():
        cfg = serve.TierConfig(max_batch_rows=32, flush_deadline_s=0.002,
                               devices=("cpu",) * n_dev)
        async with serve.ServingTier(net, cfg) as tier:
            st0 = tier.stats()
            assert st0["n_devices"] == n_dev and st0["sharded"]
            assert st0["bucket_unit"] % n_dev == 0
            assert tier._replicas[0] is net
            assert len({id(r) for r in tier._replicas}) == n_dev
            outs = await asyncio.gather(*[tier.infer(r) for r in reqs])
            return outs, tier.stats()

    outs, stats = asyncio.run(main())
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, net(r).numpy())
        np.testing.assert_array_equal(o, np.asarray(jnet(r)))
    assert stats["retraces_after_warmup"] == 0
    assert stats["compiler_runs_after_warmup"] == 0
    assert stats["batches"] < stats["requests"]


def test_cli_smoke_on_cpu(tmp_path):
    report = os.path.join(tmp_path, "report.json")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", ARTIFACT, "--smoke", "--device", "cpu",
         "--input-bw", "3", "--report-json", report,
         "--report-every-s", "0"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "layout=mixed" in proc.stdout
    assert "compile-once contract: retraces=0 compiler_runs=0" in proc.stdout
    with open(report) as fh:
        rep = json.load(fh)
    assert rep["n_requests"] == 16 and rep["n_clients"] == 4


# ---------------------------------------------------------------------------
# The LM mode of ``serve`` (no --lut): the reference's ``_run_lm`` loop
# ---------------------------------------------------------------------------

LM_STEPS = 8


def _ref_lm_loop(rcfg, params, slots: int, cache_len: int, steps: int):
    """The reference's ``repro.launch.serve._run_lm`` decode loop on one
    device: ones at position 0, then greedy, every step's logits kept."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as RS
    from repro.models import model as RM
    step = jax.jit(RS.make_decode_step(rcfg))
    cache = RM.init_cache(rcfg, slots, cache_len)
    tok = jnp.ones((slots, 1), jnp.int32)
    pos = jnp.zeros((slots,), jnp.int32)
    logits_all, tokens = [], []
    for _ in range(steps):
        logits, cache = step(params, cache, tok, pos)
        logits_all.append(np.asarray(logits.astype(jnp.float32)))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
        pos = pos + 1
    return np.stack(logits_all), np.stack(tokens)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b"])
def test_lm_mode_matches_reference_decode_loop(arch, compute_dtype):
    """``serve``'s LM mode (``lm_decode``, what ``_run_lm`` prints) from
    the reference's smoke parameters (``lm_smoke.npz`` through
    ``from_reference``) against the reference's decode loop, 8 steps of 4
    slots on a 128 cache: logits within 1e-4 at float32 compute, 0.05 at
    bfloat16; tokens equal but at a reference near-tie, after which a row
    is no longer compared (its inputs differ)."""
    import argparse
    import dataclasses
    import importlib.util

    import jax
    import jax.numpy as jnp

    from repro import configs as RC
    from repro_torch import configs as PC
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import model as M
    from torch_port_util import FIXTURE_DIR, ROOT

    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cs_spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(cs_spec)
    cs_spec.loader.exec_module(cs)
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_NAME)) as z:
        pre = f"{arch}.params."
        flat = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(PC.get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    params = jax.tree.map(jnp.asarray, tool.unflatten_params(flat))
    want_logits, want_tokens = _ref_lm_loop(rcfg, params, 4, 128, LM_STEPS)
    args = argparse.Namespace(arch=arch, full=False, slots=4, cache_len=128,
                              steps=LM_STEPS, model_parallel=None,
                              device="cpu")
    model = M.from_reference(cfg, flat, device="cpu")
    out = port_serve.lm_decode(args, cfg=cfg, model=model)
    got_logits = np.stack([lg.float().numpy() for lg in out["logits"]])
    got_tokens = out["tokens"].numpy()
    tol = ({"atol": 1e-4, "rtol": 1e-4} if compute_dtype == "float32"
           else {"atol": 0.05, "rtol": 0.05})
    live = np.ones(4, bool)
    # the rows start alike (ones at 0), so one near-tie parts all of them
    for t in range(LM_STEPS):
        np.testing.assert_allclose(got_logits[t][live], want_logits[t][live],
                                   **tol, err_msg=f"step {t}")
        _, outside = cs.token_disagreements(
            got_tokens[t][live], want_logits[t][live],
            want_tokens[t][live], **tol)
        assert outside == 0, f"step {t}: a token off a near-tie"
        live &= got_tokens[t] == want_tokens[t]
        if not live.any():
            break


def test_lm_mode_cli_and_lut_mode_on_the_cpu(tmp_path):
    """``serve`` without ``--lut`` runs the LM mode (the reference's
    ``[serve] ... ms/step`` line) and ``--model-parallel 1`` decodes the
    same tokens on a one-rank mesh; ``--lut`` still serves as before."""
    import subprocess
    import sys
    from torch_port_util import SRC
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)

    def run(*flags):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *flags,
             "--device", "cpu"], env=env, capture_output=True, text=True,
            timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    one = run("--steps", "4")
    mesh = run("--steps", "4", "--model-parallel", "1")
    assert "[serve] qwen3-1.7b-smoke: 4 decode steps x 4 slots on one " \
           "device" in one
    assert "on mesh {'data': 1, 'model': 1}" in mesh
    tokens = [ln for ln in one.splitlines() if ln.startswith("[serve] tok")]
    assert tokens and tokens == [ln for ln in mesh.splitlines()
                                 if ln.startswith("[serve] tok")]
    lut = run("--lut", "--smoke")
    assert "compile-once contract: retraces=0 compiler_runs=0" in lut
