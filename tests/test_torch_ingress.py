"""The port's HTTP ingress (``repro_torch.serve.HttpIngress``) and open-loop
load over HTTP, on the CPU.

The contracts of ``tests/test_ingress.py``, held by the port with the
kernels' plain versions (tolerance 0: integer codes), plus the reference
beside it:

* **transport correctness** — JSON and raw-int8 responses through a real
  localhost socket are bit-exact with calling the artifact directly and
  with the reference's engine (model A's level-3 artifact on the
  fixture's 4096 rows against the reference's stored outputs), keep-alive
  connections serve several requests, and steady state adds zero kernel
  builds and zero compiler runs;
* **typed error mapping** — 400/404/405/408/413/429/503 each carry the
  JSON ``{"error", "detail"}`` body, and the client raises the matching
  typed exception;
* **per-tenant quota** — the token bucket step for step against the
  reference's under an injected clock; over-quota 429s counted the same
  by the ``LoadReport`` and ``ingress_rejected_total``; tenants isolated;
* **open-loop generator** — the seeded schedule equals the reference's;
  under capacity every request completes, past it the queue sheds;
* **CLI end to end** (subprocesses, ``--device cpu``) — ``serve --lut
  --http 0 --smoke`` verifies bit-exact over HTTP; serve-forever mode
  drains on SIGTERM and still writes ``--metrics-json``.

Every socket, client and subprocess here has its own timeout, and every
server binds port 0.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_port_util import (ARTIFACT, SRC, load_ref,  # noqa: F401
                             one_torch_thread)

from repro import engine as jengine
from repro import serve as jserve
from repro_torch import engine, obs, serve
from repro_torch.serve import ingress as I

TIMEOUT = 30


@pytest.fixture(scope="module")
def triple():
    rng = np.random.default_rng(7)
    idx = np.stack([np.sort(rng.choice(12, 3, replace=False))
                    for _ in range(8)]).astype(np.int32)
    tbl = rng.integers(0, 4, (8, 2 ** 6), dtype=np.int32)
    return idx, tbl, 2


@pytest.fixture(scope="module")
def net(triple):
    """Tiny compiled artifact (no compiler pass), on the CPU."""
    return engine.compile_network([triple], in_features=12, block_b=8,
                                  device="cpu")


def _codes(net, rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, (rows, net.n_in), dtype=np.int32)


def _counter(snap, name, **labels):
    for s in snap.get(name, {}).get("series", []):
        if s["labels"] == labels:
            return s["value"]
    return 0.0


def _request(port, method, path, body=None, headers=None):
    """One blocking HTTP request against the background ingress."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _infer(port, codes, **kw):
    return asyncio.run(asyncio.wait_for(
        serve.http_infer("127.0.0.1", port, codes, timeout_s=TIMEOUT, **kw),
        TIMEOUT))


# ---------------------------------------------------------------------------
# deterministic building blocks
# ---------------------------------------------------------------------------


def test_token_bucket_injected_clock():
    b = serve.TokenBucket(rate=10.0, burst=5.0, now=0.0)
    assert b.try_take(5, now=0.0)
    assert not b.try_take(1, now=0.0)
    assert not b.try_take(2, now=0.1)
    assert b.try_take(1, now=0.1)
    assert b.try_take(5, now=100.0)
    assert b.tokens == 0.0
    assert not b.try_take(1, now=99.0)
    with pytest.raises(ValueError, match="positive"):
        serve.TokenBucket(rate=0.0, burst=5.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_equals_reference_step_for_step(seed):
    """Random takes at a jittered (sometimes backwards) clock: every
    decision and every balance equal the reference's bucket's."""
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.uniform(0.5, 50)), float(rng.uniform(1, 20))
    ours = serve.TokenBucket(rate, burst, now=0.0)
    theirs = jserve.TokenBucket(rate, burst, now=0.0)
    now = 0.0
    for _ in range(500):
        now += float(rng.uniform(-0.05, 0.3))
        n = float(rng.integers(1, 9))
        assert ours.try_take(n, now=now) == theirs.try_take(n, now=now)
        assert ours.tokens == theirs.tokens


def test_quota_config_burst_defaults_to_rate():
    assert serve.QuotaConfig(rate_rows_per_s=250.0).burst == 250.0
    assert serve.QuotaConfig(rate_rows_per_s=250.0,
                             burst_rows=7.0).burst == 7.0
    assert serve.IngressConfig() == serve.IngressConfig(
        host="127.0.0.1", port=0, quota=None, tenant_header="x-tenant",
        default_tenant="default", max_body_bytes=8 << 20)


def test_poisson_arrivals_seeded_schedule():
    a = serve.poisson_arrivals(200.0, 500, seed=3)
    np.testing.assert_array_equal(a, serve.poisson_arrivals(200.0, 500,
                                                            seed=3))
    np.testing.assert_array_equal(a, jserve.poisson_arrivals(200.0, 500,
                                                             seed=3))
    assert a.shape == (500,) and np.all(np.diff(a) >= 0)
    assert 0.5 / 200.0 < float(a[-1] / 500) < 2.0 / 200.0
    assert not np.array_equal(a, serve.poisson_arrivals(200.0, 500, seed=4))
    with pytest.raises(ValueError, match="positive"):
        serve.poisson_arrivals(0.0, 4)
    for r, s in zip(serve.make_requests(12, 6, bw=3, seed=5),
                    jserve.make_requests(12, 6, bw=3, seed=5)):
        np.testing.assert_array_equal(r, s)


# ---------------------------------------------------------------------------
# HTTP transport: bit-exact + typed errors over a real socket
# ---------------------------------------------------------------------------


def test_http_json_and_raw_bit_exact(net, triple):
    jnet = jengine.compile_network([triple], in_features=12, block_b=8)
    with serve.BackgroundIngress(net) as ing:
        codes = _codes(net, 5, seed=1)
        want = net(codes).numpy()
        np.testing.assert_array_equal(want, np.asarray(jnet(codes)))
        raw = _infer(ing.port, codes)
        as_json = _infer(ing.port, codes, raw=False)
        assert raw.dtype == as_json.dtype == np.int32
        np.testing.assert_array_equal(raw, want)
        np.testing.assert_array_equal(as_json, want)
        status, _, body = _request(
            ing.port, "POST", "/v1/infer",
            body=json.dumps({"codes": codes[0].tolist()}),
            headers={"content-type": "application/json"})
        assert status == 200
        np.testing.assert_array_equal(
            np.asarray(json.loads(body)["outputs"]), want[:1])
        stats = ing.stats()
    assert stats["retraces_after_warmup"] == 0
    assert stats["compiler_runs_after_warmup"] == 0
    assert stats["requests"] == 3


def test_keep_alive_connection_serves_several_requests(net):
    with serve.BackgroundIngress(net) as ing:
        conn = http.client.HTTPConnection("127.0.0.1", ing.port,
                                          timeout=TIMEOUT)
        try:
            for seed in range(3):
                codes = _codes(net, 2 + seed, seed=seed)
                conn.request("POST", "/v1/infer",
                             body=codes.astype(np.int8).tobytes(),
                             headers={"content-type":
                                      "application/octet-stream"})
                resp = conn.getresponse()
                assert resp.status == 200
                assert resp.getheader("connection") == "keep-alive"
                out = np.frombuffer(resp.read(), np.int8).reshape(
                    codes.shape[0], -1)
                np.testing.assert_array_equal(out, net(codes).numpy())
        finally:
            conn.close()


def test_model_a_fixture_over_http_equals_reference():
    """The fixture's 4096 rows through the level-3 artifact over HTTP, as
    JSON and as raw int8: the reference's stored outputs exactly."""
    ref = load_ref()
    net = engine.load(ARTIFACT, device="cpu")
    with serve.BackgroundIngress(net) as ing:
        raw = _infer(ing.port, ref["codes"])
        as_json = _infer(ing.port, ref["codes"], raw=False)
        stats = ing.stats()
    np.testing.assert_array_equal(raw, ref["out_mixed"])
    np.testing.assert_array_equal(as_json, ref["out_mixed"])
    assert stats["retraces_after_warmup"] == 0
    assert stats["compiler_runs_after_warmup"] == 0


def test_http_error_mappings(net):
    cfg = serve.IngressConfig(max_body_bytes=64)
    with serve.BackgroundIngress(net, config=cfg) as ing:
        port = ing.port
        for method, path, body, hdrs, status, err in [
            ("GET", "/nope", None, {}, 404, "not_found"),
            ("GET", "/v1/infer", None, {}, 405, "method_not_allowed"),
            ("POST", "/healthz", None, {}, 405, "method_not_allowed"),
            ("POST", "/metrics", None, {}, 405, "method_not_allowed"),
            ("POST", "/v1/infer", b"{not json",
             {"content-type": "application/json"}, 400, "bad_request"),
            ("POST", "/v1/infer", json.dumps({"codes": [[1, 2, 3]]}),
             {"content-type": "application/json"}, 400, "bad_request"),
            ("POST", "/v1/infer", json.dumps([1, 2]),
             {"content-type": "application/json"}, 400, "bad_request"),
            ("POST", "/v1/infer", b"\x01" * (net.n_in + 1),
             {"content-type": "application/octet-stream"}, 400,
             "bad_request"),
            ("POST", "/v1/infer", b"\x01" * (net.n_in * 8),
             {"content-type": "application/octet-stream"}, 413,
             "payload_too_large"),
        ]:
            got, _, body_out = _request(port, method, path, body, hdrs)
            assert got == status, (method, path, body_out)
            assert json.loads(body_out)["error"] == err

        # an unreadable request line: 400, then the connection closes
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=TIMEOUT) as sock:
            sock.sendall(b"NONSENSE\r\n\r\n")
            head = sock.makefile("rb").readline()
        assert head.startswith(b"HTTP/1.1 400")

        status, _, body = _request(port, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["retraces_after_warmup"] == 0
        assert health["compiler_runs_after_warmup"] == 0

        status, headers, body = _request(port, "GET", "/metrics")
        assert status == 200
        assert headers["content-type"].startswith("text/plain")
        text = body.decode()
        assert "# TYPE ingress_requests_total counter" in text
        assert 'ingress_requests_total{route="/healthz",status="200"}' \
            in text
        assert 'ingress_requests_total{route="*",status="413"}' in text
        assert "# TYPE serve_requests_total counter" in text


class _SlowNet:
    """The artifact with a fixed cost a batch, so overload and timeouts
    are deterministic."""

    def __init__(self, inner, delay_s=0.02):
        self._inner, self._delay = inner, delay_s
        self.n_in, self.n_out = inner.n_in, inner.n_out
        self.block_b, self.device = inner.block_b, inner.device

    def kernel_builds(self):
        return self._inner.kernel_builds()

    def __call__(self, codes):
        time.sleep(self._delay)
        return self._inner(codes)


def test_http_overload_503_and_timeout_408(net):
    """A slow tier behind the ingress: a request past the bounded queue
    gets 503 ``overloaded`` (TierOverloaded at the client), one that
    expires before launch gets 408 (RequestTimeout)."""
    slow = _SlowNet(net, 0.3)

    async def flood(port, n):
        return await asyncio.gather(*[
            asyncio.wait_for(serve.http_infer(
                "127.0.0.1", port, _codes(net, 4, seed=i),
                timeout_s=TIMEOUT), TIMEOUT)
            for i in range(n)], return_exceptions=True)

    tier = serve.TierConfig(max_batch_rows=4, flush_deadline_s=0.0,
                            max_queue_rows=8, warmup=False)
    before = obs.registry().snapshot()
    with serve.BackgroundIngress(slow, tier) as ing:
        res = asyncio.run(flood(ing.port, 6))
    after = obs.registry().snapshot()
    kinds = [type(r).__name__ for r in res]
    assert "TierOverloaded" in kinds and "ndarray" in kinds, kinds
    assert not [r for r in res if isinstance(r, BaseException)
                and not isinstance(r, serve.TierOverloaded)]
    assert (_counter(after, "ingress_rejected_total", reason="overloaded")
            - _counter(before, "ingress_rejected_total",
                       reason="overloaded")) == kinds.count(
                           "TierOverloaded")

    tier = serve.TierConfig(max_batch_rows=4, flush_deadline_s=0.0,
                            request_timeout_s=0.05, warmup=False)
    with serve.BackgroundIngress(slow, tier) as ing:
        res = asyncio.run(flood(ing.port, 3))
    assert any(isinstance(r, serve.RequestTimeout) for r in res), res


@pytest.mark.parametrize("status,body,exc", [
    (429, {"error": "quota_exceeded", "detail": "x"}, "QuotaExceeded"),
    (408, {"error": "timeout", "detail": "x"}, "RequestTimeout"),
    (503, {"error": "overloaded", "detail": "x"}, "TierOverloaded"),
    (503, {"error": "draining", "detail": "x"}, "TierClosed"),
    (500, {"error": "internal", "detail": "x"}, "TierError"),
])
def test_client_maps_statuses_to_typed_errors(status, body, exc):
    with pytest.raises(getattr(serve, exc)) as info:
        I._decode_infer_response(status, {}, json.dumps(body).encode(), 1)
    assert type(info.value).__name__ == exc
    with pytest.raises(getattr(jserve, exc)):
        jserve.ingress._decode_infer_response(
            status, {}, json.dumps(body).encode(), 1)


def test_draining_ingress_answers_503():
    """A request that reaches the ingress once ``stop`` began is answered
    503 ``draining`` (and counted), never served."""

    class _Net:
        n_in, n_out, block_b = 2, 1, 1

    async def main():
        ing = serve.HttpIngress(_Net())
        ing._draining = True
        return await ing._infer({}, b"\x00\x01")

    status, payload, _ = asyncio.run(main())
    assert status == 503 and payload["error"] == "draining"


# ---------------------------------------------------------------------------
# per-tenant quota: 429 accounting matches the LoadReport exactly
# ---------------------------------------------------------------------------


def test_quota_rejections_match_load_report(net):
    cfg = serve.IngressConfig(
        quota=serve.QuotaConfig(rate_rows_per_s=0.5, burst_rows=6.0))
    before = obs.registry().snapshot()
    with serve.BackgroundIngress(net, config=cfg) as ing:
        rep = serve.run_open_loop(
            url=ing.url, offered_rps=500.0, n_requests=10,
            rows_min=2, rows_max=2, seed=11, tenant="alice",
            verify_net=net)
    after = obs.registry().snapshot()
    assert rep.outcomes["ok"] == 3                     # 6 tokens / 2 rows
    assert rep.outcomes["rejected_quota"] == 7
    assert rep.rejected == 7 and rep.timed_out == 0
    assert rep.rejection_rate == pytest.approx(0.7)
    assert sum(rep.outcomes.values()) == rep.n_requests == 10
    assert rep.stats == {} and rep.breakdown == {}     # a remote tier
    delta = (_counter(after, "ingress_rejected_total", reason="quota")
             - _counter(before, "ingress_rejected_total", reason="quota"))
    assert delta == rep.outcomes["rejected_quota"]


def test_quota_isolates_tenants(net):
    cfg = serve.IngressConfig(
        quota=serve.QuotaConfig(rate_rows_per_s=0.5, burst_rows=4.0))

    async def main(port):
        codes = _codes(net, 4, seed=2)
        await serve.http_infer("127.0.0.1", port, codes, tenant="noisy",
                               timeout_s=TIMEOUT)
        with pytest.raises(serve.QuotaExceeded):
            await serve.http_infer("127.0.0.1", port, codes,
                                   tenant="noisy", timeout_s=TIMEOUT)
        return await serve.http_infer("127.0.0.1", port, codes,
                                      tenant="quiet", timeout_s=TIMEOUT)

    with serve.BackgroundIngress(net, config=cfg) as ing:
        out = asyncio.run(asyncio.wait_for(main(ing.port), TIMEOUT))
    np.testing.assert_array_equal(out, net(_codes(net, 4, seed=2)).numpy())


# ---------------------------------------------------------------------------
# open-loop generator: determinism under capacity, shedding past it
# ---------------------------------------------------------------------------


def test_open_loop_in_process_all_ok_and_deterministic(net):
    kw = dict(offered_rps=300.0, n_requests=12, rows_max=4, seed=5)
    a = serve.run_open_loop(net, **kw)
    b = serve.run_open_loop(net, **kw)
    assert a.outcomes == b.outcomes == {"ok": 12}
    assert a.rejection_rate == 0.0
    assert a.n_clients == 0
    assert a.rows == b.rows
    assert a.stats["retraces_after_warmup"] == 0
    assert a.stats["compiler_runs_after_warmup"] == 0


def test_open_loop_over_http_all_ok_and_verified(net):
    with serve.BackgroundIngress(net) as ing:
        rep = serve.run_open_loop(url=ing.url, offered_rps=400.0,
                                  n_requests=24, rows_max=8, seed=3,
                                  verify_net=net)
        stats = ing.stats()
    assert rep.outcomes == {"ok": 24}
    assert rep.n_clients == 0 and rep.rows > 24
    assert stats["requests"] == 24
    assert stats["retraces_after_warmup"] == 0


def test_open_loop_overload_sheds_not_queues(net):
    cfg = serve.TierConfig(max_batch_rows=8, flush_deadline_s=0.002,
                           max_queue_rows=8)
    rep = serve.run_open_loop(_SlowNet(net), config=cfg,
                              offered_rps=1000.0, n_requests=30,
                              rows_min=2, rows_max=4, seed=0,
                              check_outputs=False)
    assert rep.outcomes["ok"] >= 1
    assert rep.outcomes.get("rejected_overload", 0) > 0
    assert rep.rejected == (rep.outcomes.get("rejected_overload", 0)
                            + rep.outcomes.get("rejected_quota", 0)
                            + rep.outcomes.get("closed", 0))
    assert rep.goodput_rps < rep.offered_rps
    assert rep.rejection_rate == pytest.approx(
        1.0 - rep.outcomes["ok"] / rep.n_requests)


def test_open_loop_url_mode_needs_sizing():
    with pytest.raises(ValueError, match="exactly one"):
        serve.run_open_loop()
    with pytest.raises(ValueError, match="verify_net= or n_in="):
        serve.run_open_loop(url="http://127.0.0.1:1")


# ---------------------------------------------------------------------------
# CLI end to end (subprocess, --device cpu): --http --smoke, SIGTERM drain
# ---------------------------------------------------------------------------


def _subprocess_env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


@pytest.fixture(scope="module")
def artifact(net, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ingress") / "tiny.npz")
    net.save(path)
    return path


def test_cli_http_smoke_end_to_end(artifact, tmp_path):
    report = str(tmp_path / "r.json")
    metrics = str(tmp_path / "m.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", artifact, "--http", "0", "--smoke", "--device",
         "cpu", "--report-every-s", "0", "--report-json", report,
         "--metrics-json", metrics],
        env=_subprocess_env(), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "http ingress listening on http://127.0.0.1:" in proc.stdout
    assert "responses verified bit-exact over HTTP" in proc.stdout
    assert "retraces=0" in proc.stdout and "compiler_runs=0" in proc.stdout
    with open(report) as fh:
        rep = json.load(fh)
    assert rep["n_clients"] == 0
    assert sum(rep["outcomes"].values()) == rep["n_requests"] == 16
    with open(metrics) as fh:
        snap = json.load(fh)
    assert any(s["labels"].get("route") == "/v1/infer"
               for s in snap["ingress_requests_total"]["series"])
    assert all(s["count"] > 0
               for s in snap["ingress_infer_seconds"]["series"])


def test_cli_http_tenant_quota_rejects(artifact):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", artifact, "--http", "0", "--smoke", "--device",
         "cpu", "--report-every-s", "0", "--tenant-quota", "1:8"],
        env=_subprocess_env(), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'rejected_quota'" in proc.stdout


def test_cli_http_sigterm_drains_and_dumps_metrics(net, artifact,
                                                   tmp_path):
    metrics = str(tmp_path / "m.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", artifact, "--http", "0", "--device", "cpu",
         "--report-every-s", "0", "--metrics-json", metrics],
        env=_subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port, head = None, []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            head.append(line)
            if "listening on http://127.0.0.1:" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "".join(head)

        codes = _codes(net, 3, seed=9)
        np.testing.assert_array_equal(_infer(port, codes),
                                      net(codes).numpy())
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:                        # pragma: no cover
            proc.kill()
            proc.communicate(timeout=30)
    full = "".join(head) + stdout
    assert proc.returncode == 0, full + stderr[-2000:]
    assert "draining" in full
    assert f"metrics snapshot -> {metrics}" in full
    with open(metrics) as fh:
        snap = json.load(fh)
    assert any(s["labels"].get("route") == "/v1/infer"
               and s["labels"].get("status") == "200"
               for s in snap["ingress_requests_total"]["series"])
    for name in ("serve_retraces_after_warmup",
                 "serve_compiler_runs_after_warmup"):
        assert all(s["value"] == 0 for s in snap[name]["series"]), name
