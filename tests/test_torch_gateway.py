"""The port's serving gateway on the CPU: its metrics registry and load
generator against the reference's, and the gateway surface of its runtime
on the port's engine (``device="cpu"``).

``repro_torch.serving.metrics`` must render exactly the reference's text
after the same observations, and ``repro_torch.serving.loadgen`` must draw
bit-identical arrivals, lengths and prompts from the same seed.  Then, on the
port's engine: both backpressure policies, lossless per-token streaming
under threaded co-serving with the greedy tokens of a plain engine run,
streams closed by ``stop``, and the two failure domains: a request-scoped
fault during replay (survivors exact) and an engine-fatal one (streams
closed with the error, health FAILED), whether injected or raised by the
kernel layer as a CUDA error would be.  Every threaded wait is bounded.
"""
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.serving import loadgen as loadgen_ref  # noqa: E402
from repro.serving import metrics as metrics_ref  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    EngineDead,
    FaultInjector,
    FaultSpec,
    RequestFailed,
    RuntimeHealth,
)
from repro_torch.core.request import Phase, Priority  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import loadgen, metrics  # noqa: E402
from repro_torch.serving.api import Frontend, QueueFull, QueueTimeout  # noqa: E402
from repro_torch.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch.serving.runtime import CoServingRuntime, ManualClock, ServingConfig  # noqa: E402
from test_torch_runtime import CFG, PARAMS, WAIT_S, mkreq  # noqa: E402


def mkengine(**eng_kw):
    eng_kw.setdefault("max_model_len", 128)
    eng_kw.setdefault("num_device_blocks", 128)
    return RealEngine(CFG, PARAMS, eng_cfg=RealEngineConfig(**eng_kw),
                      slo=SLO(ttft=1.5, tpot=0.110), device="cpu")


# ---------------------------------------------------------------------------
# metrics and loadgen against the reference
# ---------------------------------------------------------------------------


def _observe(mod):
    """The same observations on a fresh registry of ``mod``: counters by
    inc and set_to (with a refused step back), gauges with integral,
    fractional and negative values, and histograms at default and custom
    bounds, overflow included."""
    reg = mod.MetricsRegistry()
    reg.counter("requests_total").inc()
    reg.counter("requests_total").inc(2.5)
    reg.counter("iterations_total").set_to(41)
    reg.counter("iterations_total").set_to(40)
    reg.gauge("queue_depth_online").set(7)
    reg.gauge("calibration_drift").set(1.0 / 3.0)
    reg.gauge("delta").set(-2e-9)
    rng = np.random.default_rng(3)
    h = reg.histogram("ttft_seconds")
    for v in rng.exponential(0.2, 200):
        h.observe(float(v))
    h.observe(1e6)
    c = reg.histogram("steps", bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 9.0):
        c.observe(v)
    reg.histogram("empty")
    return reg


def test_metrics_text_matches_the_reference():
    ours, ref = _observe(metrics), _observe(metrics_ref)
    assert ours.render_text() == ref.render_text()
    assert ours.snapshot() == ref.snapshot()
    assert "ttft_seconds_p99" in ours.render_text()


def _draws(mod, seed):
    rng = np.random.default_rng(seed)
    arrivals = {
        "gamma": mod.gamma_arrivals(3.0, 2.0, 30.0, rng),
        "onoff": mod.onoff_arrivals(5.0, 4.0, 6.0, 40.0, rng),
        "inhomogeneous": mod.inhomogeneous_arrivals(
            lambda t: mod.burstgpt_like_rate_profile(t, 1.5), 6.0, 900.0, rng),
    }
    online = mod.make_online_requests(arrivals["gamma"][:20],
                                      mod.LengthSpec(64, 48, 0.25, 0.5), rng)
    offline = mod.make_offline_batch(12, mod.LengthSpec(128, 48, 0.1, 0.1), rng,
                                     arrival_time=0.5)
    mod.attach_prompts(online + offline, 32000, rng)
    reqs = [(r.priority.name, r.prompt_len, r.max_new_tokens, r.arrival_time,
             r.prompt.tolist()) for r in online + offline]
    return arrivals, reqs


@pytest.mark.parametrize("seed", [0, 7])
def test_loadgen_is_bit_identical_to_the_reference(seed):
    ours, ref = _draws(loadgen, seed), _draws(loadgen_ref, seed)
    for name in ("gamma", "onoff", "inhomogeneous"):
        assert len(ours[0][name]) > 10
        assert np.array_equal(np.asarray(ours[0][name]), np.asarray(ref[0][name])), name
    assert ours[1] == ref[1]


# ---------------------------------------------------------------------------
# backpressure on the port's engine (no engine thread)
# ---------------------------------------------------------------------------


def test_queue_with_timeout_honored_under_manual_clock():
    eng = mkengine()
    clock = ManualClock()
    rt = CoServingRuntime(
        eng, clock=clock, manual=True,
        serving=ServingConfig(max_queued_online=1, policy="queue-with-timeout",
                              queue_timeout_s=0.5, backpressure_poll_s=0.01),
    )
    rt.submit(mkreq(Priority.ONLINE, 16, 4, 0))  # fills the online budget
    t0 = clock.t
    with pytest.raises(QueueTimeout):
        rt.submit(mkreq(Priority.ONLINE, 16, 4, 1))
    assert 0.5 <= clock.t - t0 <= 0.5 + 0.01 + 1e-9
    with rt._lock:
        assert len(rt._pending) == 1
    snap = rt.registry.snapshot()
    assert snap["ingress_queue_timeout_total_online"] == 1
    assert snap["ingress_submitted_total_online"] == 1


def test_reject_fast_leaves_zero_state():
    eng = mkengine()
    rt = CoServingRuntime(eng, clock=ManualClock(), manual=True,
                          serving=ServingConfig(max_queued_offline=2, policy="reject-fast"))
    fe = Frontend(rt, clock=rt.now)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, 16).astype(np.int32) for _ in range(2)]
    fe.submit_batch(prompts, max_new_tokens=4)
    with pytest.raises(QueueFull):
        rt.submit(mkreq(Priority.OFFLINE, 16, 4, 9))
    assert eng.blocks.used_device_blocks == 0
    assert not eng.sched.offline_q and not eng.sched.online_q
    with rt._lock:
        assert len(rt._pending) == 2
    with pytest.raises(QueueFull):
        fe.submit_batch(prompts, max_new_tokens=4)
    with rt._lock:
        assert len(rt._pending) == 2
    assert rt.registry.snapshot()["ingress_queue_full_total_offline"] == 2
    # the online class still admits under an offline flood
    online = mkreq(Priority.ONLINE, 16, 4, 100)
    rt.submit(online)
    with rt._lock:
        assert online in rt._pending


# ---------------------------------------------------------------------------
# threaded streaming on the port's engine
# ---------------------------------------------------------------------------

ONLINE_SPECS = [(16, 4, 0), (24, 4, 1), (20, 4, 2)]
OFFLINE_SPECS = [(24, 4, 10), (32, 4, 11)]


def _plain_tokens():
    """The same prompts through a plain single-threaded engine run."""
    eng = mkengine()
    reqs = [mkreq(Priority.ONLINE, p, g, s) for (p, g, s) in ONLINE_SPECS]
    reqs += [mkreq(Priority.OFFLINE, p, g, s) for (p, g, s) in OFFLINE_SPECS]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("policy", ["queue-with-timeout", "reject-fast"])
def test_threaded_streaming_lossless_under_load(policy):
    plain = _plain_tokens()
    rt = CoServingRuntime(mkengine(), serving=ServingConfig(policy=policy))
    fe = Frontend(rt, clock=rt.now)
    collected = {i: [] for i in range(len(ONLINE_SPECS))}
    consumers, handles = [], []

    def consume(idx, handle):
        for tok in handle:
            collected[idx].append(tok)

    rt.start()
    try:
        offline = [mkreq(Priority.OFFLINE, p, g, s) for (p, g, s) in OFFLINE_SPECS]
        rt.submit_all(offline)
        for i, (p, g, s) in enumerate(ONLINE_SPECS):
            h = fe.stream(mkreq(Priority.ONLINE, p, g, s).prompt, g)
            assert h.channel is not None
            th = threading.Thread(target=consume, args=(i, h), daemon=True)
            th.start()
            consumers.append(th)
            handles.append(h)
    finally:
        rt.stop(drain=True, timeout=WAIT_S)
    for th in consumers:
        th.join(timeout=WAIT_S)
        assert not th.is_alive(), "stream consumer did not terminate"
    for i, h in enumerate(handles):
        assert h.finished
        assert collected[i] == list(h.request.output_tokens)
        assert len(collected[i]) == ONLINE_SPECS[i][1]
        assert h.channel.pushes >= 2  # per token, not one blob
    assert all(r.phase == Phase.FINISHED for r in offline)
    got = [list(h.request.output_tokens) for h in handles]
    got += [list(r.output_tokens) for r in offline]
    assert got == plain
    final = rt.registry.snapshot()
    m = rt.metrics()
    assert abs(final["slo_ttft_attainment"] - m.ttft_slo_attainment) < 1e-9
    assert final["queue_depth_online"] == final["queue_depth_offline"] == 0
    assert final["tokens_generated_total_online"] == sum(g for _p, g, _s in ONLINE_SPECS)


def test_threaded_stop_closes_unfinished_streams():
    rt = CoServingRuntime(mkengine())
    fe = Frontend(rt, clock=rt.now)
    rt.start()
    try:
        h = fe.stream(mkreq(Priority.ONLINE, 16, 4, 0).prompt, 64)
        done = threading.Event()
        got = []

        def consume():
            for tok in h:
                got.append(tok)
            done.set()

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        time.sleep(0.3)  # let a few tokens flow
    finally:
        rt.stop(drain=False, timeout=WAIT_S)
    assert done.wait(WAIT_S), "consumer still blocked after stop()"
    th.join(timeout=WAIT_S)
    assert got == list(h.request.output_tokens)  # a prefix, nothing invented
    assert h.channel.closed


# ---------------------------------------------------------------------------
# failure domains
# ---------------------------------------------------------------------------


def test_request_fault_in_replay_spares_survivors_exactly():
    specs = [(40, 24, 0), (40, 24, 1), (40, 24, 2)]
    eng = mkengine()
    plain = [mkreq(Priority.OFFLINE, p, g, s) for p, g, s in specs]
    for r in plain:
        eng.submit(r)
    eng.run()

    reqs = [mkreq(Priority.OFFLINE, p, g, s) for p, g, s in specs]
    victim = reqs[1]
    faults = FaultInjector([FaultSpec("dispatch", at=4, scope="request",
                                      request_id=victim.request_id)])
    eng = mkengine(faults=faults)
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-4),
                          serving=ServingConfig(health_recovery_iters=5))
    vch = rt.register_stream(victim)
    sch = rt.register_stream(reqs[0])
    m = rt.replay(reqs)
    assert faults.injected == 1 and rt.stats.requests_failed == 1
    assert rt.failed == [victim] and victim.phase == Phase.FAILED
    assert isinstance(victim.error, RequestFailed)
    assert m.num_finished == 2
    assert [reqs[0].output_tokens, reqs[2].output_tokens] == [
        plain[0].output_tokens, plain[2].output_tokens]
    assert list(sch) == plain[0].output_tokens
    drained = []
    with pytest.raises(RequestFailed):
        for tok in vch:
            drained.append(tok)
    assert drained == plain[1].output_tokens[: len(drained)]
    eng.blocks.check_invariants()
    assert rt.health == RuntimeHealth.HEALTHY
    assert rt.registry.snapshot()["requests_failed_total"] == 1


def _kernel_layer_error(monkeypatch):
    """The kernel layer raising as a CUDA error surfaces in PyTorch (an
    illegal access is sticky: every later call fails too)."""
    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ops, "ragged_paged_attention", broken)
    return None


def _injected_engine_fault(monkeypatch):
    return FaultInjector([FaultSpec("dispatch", at=2, scope="engine")])


@pytest.mark.parametrize("source", [_injected_engine_fault, _kernel_layer_error],
                         ids=["injected", "kernel-error"])
def test_engine_fatal_closes_streams_and_fails_health(source, monkeypatch):
    """Anything but a ``RequestFailed`` is engine-fatal: never retried as a
    request fault; every stream is closed with ``EngineDead``, health is
    FAILED, and submissions fail fast -- in replay and threaded."""
    faults = source(monkeypatch)
    reqs = [mkreq(Priority.OFFLINE, 24, 8, s) for s in range(2)]
    eng = mkengine(faults=faults)
    recovered = []
    orig = eng.recover_from_fault
    eng.recover_from_fault = lambda: (recovered.append(1), orig())[1]
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-4))
    ch = rt.register_stream(reqs[0])
    with pytest.raises(EngineDead):
        rt.replay(reqs)
    assert not recovered and rt.stats.requests_failed == 0
    assert rt.health == RuntimeHealth.FAILED
    assert ch.closed
    with pytest.raises(EngineDead):
        list(ch)
    with pytest.raises(EngineDead):
        rt.submit(mkreq(Priority.ONLINE, 16, 4, 9))
    assert rt.registry.snapshot()["engine_health"] == int(RuntimeHealth.FAILED)

    rt2 = CoServingRuntime(mkengine(faults=source(monkeypatch)))
    fe = Frontend(rt2, clock=rt2.now)
    rt2.start()
    try:
        h = fe.stream(mkreq(Priority.ONLINE, 24, 16, 0).prompt, 16)
        errors = []

        def consume():
            try:
                for _tok in h:
                    pass
            except EngineDead as e:
                errors.append(e)

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        th.join(timeout=WAIT_S)
        assert not th.is_alive(), "consumer never woke after engine death"
        assert errors
        assert rt2.check_health()[0] == RuntimeHealth.FAILED
    finally:
        rt2.stop(drain=True, timeout=WAIT_S)
    assert rt2._thread is None


# ---------------------------------------------------------------------------
# the launcher: --mode wallclock and its metrics endpoint
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    """GET on 127.0.0.1 with proxies off: (status, body)."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(url, timeout=WAIT_S) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_serves_text_and_health():
    reg = metrics.MetricsRegistry()
    reg.counter("iterations_total").inc(3)
    state = [RuntimeHealth.HEALTHY]
    srv = serve.metrics_server(reg, 0, health_cb=lambda: (state[0], 0.25))
    try:
        port = srv.server_address[1]
        assert _get(f"http://127.0.0.1:{port}/") == (200, reg.render_text())
        assert _get(f"http://127.0.0.1:{port}/health") == (
            200, "health HEALTHY\nheartbeat_age_seconds 0.250\n")
        state[0] = RuntimeHealth.FAILED
        code, body = _get(f"http://127.0.0.1:{port}/health")
        assert code == 503 and body.startswith("health FAILED")
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture
def one_intra_op_thread():
    """One intra-op thread while two Python threads run operators: the
    engine thread's operator pools otherwise spin against the other
    workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_wallclock_runs_to_its_end_on_the_cpu(capsys, one_intra_op_thread):
    """``--mode wallclock --device cpu --dtype float32`` on the reduced
    model: calibration, the threaded runtime with its metrics endpoint, a
    few online streams and an offline batch, every token streamed."""
    serve.main(["--mode", "wallclock", "--device", "cpu", "--dtype", "float32",
                "--duration", "1.0", "--rate", "4", "--offline", "3",
                "--metrics-port", str(_free_port()), "--metrics"])
    out = capsys.readouterr().out
    m = re.search(r"online streams=(\d+) finished=(\d+) shed=0 .* batch done=True", out)
    assert m and int(m[1]) > 0 and m[1] == m[2], out
    m = re.search(r"tokens streamed per-token: (\d+) \(generated (\d+)\)", out)
    assert m and m[1] == m[2], out
    assert "health=HEALTHY" in out and "iterations_total" in out


def test_serve_refuses_tensor_parallelism_and_needs_a_card():
    # --tp shards the paged pools; the contiguous backend refuses it
    with pytest.raises(ValueError, match="paged backend"):
        serve.main(["--mode", "wallclock", "--device", "cpu", "--tp", "2",
                    "--backend", "contiguous"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--mode", "wallclock"])  # the default device is cuda
