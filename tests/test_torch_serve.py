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
