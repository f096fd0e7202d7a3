"""The port's wall-clock runtime (``repro_torch.serving.runtime``) driving the
port's ``RealEngine`` on the CPU.

The scenarios of the reference's ``tests/test_wallclock_runtime.py`` run
here on the port's engine (``device="cpu"``): a safepoint abort on an online
arrival, the abort trigger's lifetime, waits through the injected sleep,
loud ``max_steps`` exhaustion, admission rejection through the runtime and a
``Frontend``, replay under a ``ManualClock`` and a threaded ``Frontend``.
Every threaded wait is bounded.  A differential test replays one trace with
a forced safepoint abort under a ``ManualClock`` through the reference's
runtime and engine and through the port's, with the same weights and
prompts, on the fused, the split and the pipelined path: every request's
tokens, the safepoint aborts, the preemptions, the discarded staged batches
and the finished counts must agree, with the top-2 margin guard of
``tests/test_torch_engine.py``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core.profiler import TPU_V5E  # noqa: E402
from repro.core.request import Priority as PriorityRef, Request as RequestRef  # noqa: E402
from repro.core.slo import SLO as SLORef  # noqa: E402
from repro.serving.real_engine import RealEngine as RealEngineRef  # noqa: E402
from repro.serving.real_engine import RealEngineConfig as RealEngineConfigRef  # noqa: E402
from repro.serving.runtime import CoServingRuntime as CoServingRuntimeRef  # noqa: E402
from repro.serving.runtime import ManualClock as ManualClockRef  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, HardwareSpec  # noqa: E402
from repro_torch.core.request import Phase, Priority, Request  # noqa: E402
from repro_torch.core.scheduler import AdmissionError  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.serving.api import Frontend  # noqa: E402
from repro_torch.serving.loadgen import (  # noqa: E402
    LengthSpec,
    attach_prompts,
    make_offline_batch,
    make_online_requests,
)
from repro_torch.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch.serving.runtime import CoServingRuntime, ManualClock  # noqa: E402
from test_torch_engine import (  # noqa: E402,F401
    MARGIN_BOUND, _prompt, _weights, reference_checkpoints_written_blocks,
)

CFG = get_config("llama-2-7b").reduced()
PARAMS = bridge.to_torch(_weights("llama-2-7b")[2])
# bounds every wait of the threaded tests (the suite has no timeout plugin)
WAIT_S = 60.0


def mkreq(prio, plen, gen, seed):
    return Request(prio, prompt_len=plen, max_new_tokens=gen,
                   prompt=_prompt(CFG.vocab_size, plen, seed))


def mkengine(**eng_kw):
    eng_kw.setdefault("max_model_len", 128)
    eng_kw.setdefault("num_device_blocks", 128)
    # ttft=0 makes Algorithm 2 trip on ANY online arrival into a
    # pure-offline batch: the deterministic trigger of the abort tests
    return RealEngine(CFG, PARAMS, eng_cfg=RealEngineConfig(**eng_kw),
                      slo=SLO(ttft=0.0, tpot=10.0), device="cpu")


def stop_bounded(rt, drain=True):
    rt.stop(drain=drain, timeout=WAIT_S)


# ---------------------------------------------------------------------------
# Algorithm 2 at a real safepoint
# ---------------------------------------------------------------------------


def test_online_arrival_aborts_offline_batch_at_safepoint():
    ref_eng = mkengine()
    ref = [mkreq(Priority.OFFLINE, 24, 16, s) for s in range(3)]
    for r in ref:
        ref_eng.submit(r)
    ref_eng.run()

    eng = mkengine()
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-4), manual=True)
    reqs = [mkreq(Priority.OFFLINE, 24, 16, s) for s in range(3)]
    for r in reqs:
        eng.submit(r)
    # run until the pure-offline pool is decoding (safepoints armed)
    while any(r.phase != Phase.DECODE for r in reqs):
        assert eng.step()

    # the online request lands on the "API thread": queued in the runtime's
    # ingress, not yet visible to the scheduler
    online = mkreq(Priority.ONLINE, 20, 4, 99)
    rt.submit(online)
    assert online not in eng.sched.online_q

    before = eng.safepoints.stats.preemptions
    eng.step()  # pure-offline decode: the first safepoint drains and aborts
    rt._observe_aborts()
    assert eng.safepoints.stats.preemptions == before + 1
    assert rt.stats.safepoint_aborts >= 1
    assert online in eng.sched.online_q  # delivered by the safepoint drain

    eng.run()
    assert len(online.output_tokens) == 4
    # the abort does not perturb the offline tokens
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in ref]
    assert len(rt.stats.preemption_latencies) == rt.stats.safepoint_aborts


def test_abort_trigger_survives_until_matching_abort():
    """A flag set at a late safepoint is consumed only at a later boundary:
    the trigger survives until its abort, and clears when the flag is
    consumed without one."""
    eng = mkengine()
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-3))

    rt._abort_trigger_t = rt.now()
    eng.flag.set()
    rt._observe_aborts()
    assert rt._abort_trigger_t is not None
    assert rt.stats.preemption_latencies == []

    eng.safepoints.stats.preemptions += 1
    rt._observe_aborts()
    assert rt._abort_trigger_t is None
    assert len(rt.stats.preemption_latencies) == 1
    assert rt.stats.safepoint_aborts == 1
    assert rt.stats.preemption_latencies[0] >= 0.0

    rt._abort_trigger_t = rt.now()
    eng.flag.clear()
    rt._observe_aborts()
    assert rt._abort_trigger_t is None
    assert len(rt.stats.preemption_latencies) == 1


def test_runtime_waits_route_through_injected_sleep():
    """``start()``'s idle loop and ``stop()``'s drain wait go through the
    injected sleep, so a ManualClock runtime never busy-waits real time."""
    clock = ManualClock()
    sleeps = []

    def fake_sleep(dt):
        sleeps.append(dt)
        clock.advance(dt)

    rt = CoServingRuntime(mkengine(), clock=clock, sleep=fake_sleep)
    rt.start()
    t0 = time.monotonic()
    while not sleeps and time.monotonic() - t0 < 5.0:
        time.sleep(0.001)
    assert sleeps, "idle engine loop never called the injected sleep"
    stop_bounded(rt)
    assert rt._thread is None

    clock2 = ManualClock()

    def fake_sleep2(dt):
        sleeps.append(dt)
        clock2.advance(dt)

    rt2 = CoServingRuntime(mkengine(), clock=clock2, sleep=fake_sleep2)
    rt2._sched_depths = (1, 0, 0, 0)  # a drain wait that cannot be satisfied
    rt2._thread = threading.Thread(target=lambda: time.sleep(0.2))
    rt2._thread.start()
    worker = rt2._thread
    n_before = len(sleeps)
    t0 = time.monotonic()
    rt2.stop(drain=True, timeout=0.05)
    assert time.monotonic() - t0 < 2.0  # manual time, not wall time
    assert len(sleeps) > n_before
    worker.join(timeout=5.0)
    assert not worker.is_alive()


def test_replay_max_steps_exhaustion_is_loud():
    rt = CoServingRuntime(mkengine(), clock=ManualClock(auto_tick=1e-4))
    with pytest.warns(RuntimeWarning, match="max_steps"):
        rt.replay([mkreq(Priority.OFFLINE, 24, 16, 0)], max_steps=2)
    assert rt.stats.steps_exhausted

    rt2 = CoServingRuntime(mkengine(), clock=ManualClock(auto_tick=1e-4))
    rt2.replay([mkreq(Priority.OFFLINE, 20, 4, 1)])
    assert not rt2.stats.steps_exhausted


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_rejection_via_runtime_and_frontend():
    eng = mkengine(max_model_len=64)
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-4))
    with pytest.raises(AdmissionError):
        rt.submit(mkreq(Priority.ONLINE, 60, 10, 0))
    with rt._lock:
        assert not rt._pending

    fe = Frontend(rt, clock=rt.now)
    rng = np.random.default_rng(1)
    good = rng.integers(0, CFG.vocab_size, 20).astype(np.int32)
    bad = rng.integers(0, CFG.vocab_size, 60).astype(np.int32)
    with pytest.raises(AdmissionError):
        fe.submit_batch([good, bad], max_new_tokens=10)
    with rt._lock:
        assert not rt._pending
    assert not eng.sched.offline_q
    assert eng.blocks.used_device_blocks == 0
    with pytest.raises(AdmissionError):
        fe.stream(bad, max_new_tokens=10)


def test_oversized_trace_requests_counted_not_fatal():
    rt = CoServingRuntime(mkengine(max_model_len=64), clock=ManualClock(auto_tick=1e-4))
    good = mkreq(Priority.OFFLINE, 20, 4, 0)
    bad = mkreq(Priority.OFFLINE, 60, 10, 1)
    m = rt.replay([good, bad])
    assert rt.stats.rejected == 1
    assert rt.stats.arrivals_delivered == 1
    assert m.num_finished == 1
    assert len(good.output_tokens) == 4


# ---------------------------------------------------------------------------
# replay and the threaded Frontend
# ---------------------------------------------------------------------------


def test_replay_trace_under_manual_clock():
    eng = mkengine()
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=2e-3))
    rng = np.random.default_rng(5)
    online = make_online_requests([0.05, 0.4], LengthSpec(16, 4), rng)
    offline = make_offline_batch(2, LengthSpec(24, 6), rng)
    attach_prompts(online + offline, CFG.vocab_size, rng)
    m = rt.replay(online + offline)
    assert m.num_finished == 4
    assert rt.stats.arrivals_delivered == 4
    assert all(len(r.output_tokens) == 4 for r in online)
    assert all(r.ttft is not None and r.ttft >= 0.0 for r in online)
    assert m.throughput_tokens_per_s > 0.0


def test_threaded_runtime_serves_frontend():
    rt = CoServingRuntime(mkengine())
    fe = Frontend(rt, clock=rt.now)
    rng = np.random.default_rng(6)
    rt.start()
    try:
        job = fe.submit_batch(
            [rng.integers(0, CFG.vocab_size, 24).astype(np.int32) for _ in range(2)],
            max_new_tokens=4,
        )
        handle = fe.stream(rng.integers(0, CFG.vocab_size, 16).astype(np.int32), 4)
    finally:
        stop_bounded(rt)
    assert rt._thread is None
    assert handle.finished and len(handle.poll()) == 4
    assert job.done and all(len(o) == 4 for o in job.results())


# ---------------------------------------------------------------------------
# differential: the reference's runtime and engine against the port's
# ---------------------------------------------------------------------------

# three offline jobs on a 14-block pool; two online requests whose arrival
# times, under ManualClock(auto_tick=1e-3), land the first mid-batch on a
# pure-offline decode (a safepoint abort) and force a preemption
DIFF_JOBS = [(40, 16)] * 3
DIFF_ONLINE = [(0.03, 30, 6), (0.07, 20, 4)]
# the same trace with its arrivals 15 ms later: there the reference's
# pipelined runtime aborts a pure-offline batch at a safepoint
DIFF_ONLINE_PIPELINED_ABORT = [(0.045, 30, 6), (0.085, 20, 4)]


def _diff_trace(make, online=DIFF_ONLINE):
    reqs = [make(False, p, g, 0.0, s) for s, (p, g) in enumerate(DIFF_JOBS)]
    reqs += [make(True, p, g, t, 100 + s) for s, (t, p, g) in enumerate(online)]
    return reqs


def _diff_reference(eng_kw, online=DIFF_ONLINE):
    cfg, params, _ = _weights("llama-2-7b")
    eng = RealEngineRef(cfg, params, eng_cfg=RealEngineConfigRef(**eng_kw),
                        slo=SLORef(ttft=0.0, tpot=10.0))

    def make(on, plen, gen, t, seed):
        return RequestRef(PriorityRef.ONLINE if on else PriorityRef.OFFLINE, prompt_len=plen,
                          max_new_tokens=gen, arrival_time=t,
                          prompt=_prompt(cfg.vocab_size, plen, seed))

    rt = CoServingRuntimeRef(eng, clock=ManualClockRef(auto_tick=1e-3))
    reqs = _diff_trace(make, online)
    return reqs, rt, rt.replay(reqs)


def _diff_port(eng_kw, online=DIFF_ONLINE):
    eng = RealEngine(CFG, PARAMS, eng_cfg=RealEngineConfig(**eng_kw),
                     slo=SLO(ttft=0.0, tpot=10.0), device="cpu")
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(CFG, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    eng.margins = {}

    def make(on, plen, gen, t, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, arrival_time=t,
                       prompt=_prompt(CFG.vocab_size, plen, seed))

    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-3))
    reqs = _diff_trace(make, online)
    return reqs, rt, rt.replay(reqs)


@pytest.mark.parametrize("leg", ["fused", "split", "pipelined"])
def test_runtime_matches_reference_runtime(leg):
    fused = leg != "split"
    eng_kw = dict(max_model_len=128, num_device_blocks=14, fused_batch=fused,
                  pipeline=leg == "pipelined")
    ref, ref_rt, ref_m = _diff_reference(eng_kw)
    got, rt, m = _diff_port(eng_kw)
    eng = rt.engine
    low = min(min(v) for v in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= "
        f"{MARGIN_BOUND}, so token identity with the reference is not meaningful"
    )
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ref]
    assert [len(r.output_tokens) for r in got] == [g for _p, g in DIFF_JOBS] + [
        g for _t, _p, g in DIFF_ONLINE]
    assert rt.stats.safepoint_aborts == ref_rt.stats.safepoint_aborts
    # the serial engines abort at a safepoint on this trace; the pipelined
    # engines (both packages) read the manual clock at other points, and
    # the arrivals land between batches
    assert rt.stats.safepoint_aborts >= (leg != "pipelined")
    npre = sum(r.num_preemptions for r in ref)
    assert sum(r.num_preemptions for r in got) == npre >= 1
    assert m.num_finished == ref_m.num_finished == len(got)
    assert not rt.stats.steps_exhausted and not ref_rt.stats.steps_exhausted
    d = eng.dispatches
    assert (d["fused_segment"] > 0) == fused and (d["prefill"] > 0) != fused
    # the reference runtime over its pipelined engine: the same staged
    # batches discarded by the same arrivals
    assert eng.pipeline_discards == ref_rt.engine.pipeline_discards
    assert (eng.pipeline_discards > 0) == (leg == "pipelined")


def test_pipelined_runtime_aborts_at_a_safepoint_as_the_reference_does(
        reference_checkpoints_written_blocks):
    """An Algorithm 2 abort of a staged batch against the reference's
    pipelined engine: on this trace the reference's pipelined runtime
    aborts a pure-offline batch at a safepoint.  The port's emits the same
    tokens, the same safepoint aborts, preemptions and discarded staged
    batches, and finishes every request.  A request is preempted here with
    its context at a block boundary, so the reference runs with its
    checkpoint fault repaired in this process (the fixture), as the port
    runs; unrepaired, its restored block holds one stale slot."""
    eng_kw = dict(max_model_len=128, num_device_blocks=14, pipeline=True)
    ref, ref_rt, ref_m = _diff_reference(eng_kw, DIFF_ONLINE_PIPELINED_ABORT)
    got, rt, m = _diff_port(eng_kw, DIFF_ONLINE_PIPELINED_ABORT)
    eng = rt.engine
    low = min(min(v) for v in eng.margins.values())
    assert low > MARGIN_BOUND, f"near-tie: a top-2 logit margin of {low:.2e}"
    assert ref_rt.stats.safepoint_aborts >= 1, "the reference must abort on this trace"
    assert rt.stats.safepoint_aborts == ref_rt.stats.safepoint_aborts
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ref]
    npre = sum(r.num_preemptions for r in ref)
    assert sum(r.num_preemptions for r in got) == npre >= 1
    assert eng.pipeline_discards == ref_rt.engine.pipeline_discards > 0
    assert m.num_finished == ref_m.num_finished == len(got)
    assert not rt.stats.steps_exhausted and not ref_rt.stats.steps_exhausted
