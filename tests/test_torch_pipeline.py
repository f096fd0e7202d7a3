"""The port's async host/device pipeline (``RealEngineConfig(pipeline=True)``,
DESIGN.md §13) on the CPU.

The pipelined engine plans and builds iteration N+1 while N runs, commits
structurally, fetches sampled tokens asynchronously and injects pending
tokens on the device.  It must emit the port's serial fused tokens on the
six differential cases of ``tests/test_backend_differential.py`` (with the
top-2 margin guard of ``tests/test_torch_engine.py``), and the reference's
pipelined engine's tokens, preemptions and ``pipeline_discards`` on a
preempting Llama case and a Qwen2 case.  Then the counterparts of the
reference's pipeline tests: a safepoint abort of a staged batch, a fault
that discards staged speculation under the runtime, the shared-prefix leg,
the retrace guard, and tp = 2 on CPU shards; and the steady state itself
(one fetch in flight, placeholders patched by the injection) and the
pipelined calibration depth.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.profiler import TPU_V5E  # noqa: E402
from repro.core.request import Priority as PriorityRef, Request as RequestRef  # noqa: E402
from repro.serving.real_engine import RealEngine as RealEngineRef  # noqa: E402
from repro.serving.real_engine import RealEngineConfig as RealEngineConfigRef  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultSpec, RuntimeHealth  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, CalibrationGrid, HardwareSpec  # noqa: E402
from repro_torch.core.request import Phase, Priority, Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch.serving.runtime import CoServingRuntime, ManualClock, ServingConfig  # noqa: E402
from test_backend_differential import CASES  # noqa: E402
from test_torch_engine import MARGIN_BOUND, _drive, _prompt, _run_port, _weights  # noqa: E402


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test, as ``tests/test_torch_tp_engine.py``
    has: the engines run many small operators, whose thread pools otherwise
    spin against the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(arch="llama-2-7b", slo=SLO(), **eng_kw):
    """The port's engine on the CPU with the reference's weights and prior
    latency model, so its scheduler plans as the reference's does."""
    cfg = get_config(arch).reduced()
    eng = RealEngine(cfg, bridge.to_torch(_weights(arch)[2]),
                     eng_cfg=RealEngineConfig(**eng_kw), slo=slo, device="cpu")
    eng.sched.model = AnalyticalCostModel(cfg, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    return eng


def _mk(cfg):
    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))
    return mk


def _guard(eng):
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= "
        f"{MARGIN_BOUND}, so token identity is not meaningful"
    )


@pytest.mark.parametrize("arch,jobs,preempt_step,eng_kw", CASES)
def test_pipelined_emits_serial_tokens(arch, jobs, preempt_step, eng_kw):
    ser, ser_on, ser_eng = _run_port(arch, jobs, preempt_step, eng_kw)
    got, got_on, eng = _run_port(arch, jobs, preempt_step, dict(eng_kw, pipeline=True))
    _guard(eng)
    assert [len(r.output_tokens) for r in got] == [g for _, g in jobs]
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ser]
    assert [r.output_tokens for r in got_on] == [r.output_tokens for r in ser_on]
    npre = sum(r.num_preemptions for r in ser)
    assert sum(r.num_preemptions for r in got) == npre
    if preempt_step is not None:
        assert npre > 0, "preemption scenario did not preempt"
        assert eng.restored_blocks > 0 and eng.ckpt_gathers > 0
        assert eng.pipeline_discards >= 1, "the arrivals did not discard a staged batch"
    # the margins come back through the fetches, one per sampled token
    assert sorted(eng.margins.values()) == sorted(ser_eng.margins.values())
    assert not eng._fetches and not eng._ckpt_pending and eng._staged is None
    assert eng.dispatches["fused_segment"] > 0 and eng.pipeline_trace_count > 0


@pytest.mark.parametrize("arch,jobs,preempt_step,eng_kw", [CASES[2], CASES[5]],
                         ids=["llama-preempt", "qwen2-preempt"])
def test_pipelined_emits_reference_pipelined_tokens(arch, jobs, preempt_step, eng_kw):
    cfg, params, _ = _weights(arch)
    ref_eng = RealEngineRef(cfg, params, eng_cfg=RealEngineConfigRef(pipeline=True, **eng_kw))

    def mk_ref(on, plen, gen, seed):
        return RequestRef(PriorityRef.ONLINE if on else PriorityRef.OFFLINE, prompt_len=plen,
                          max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    ref, ref_on = _drive(ref_eng, mk_ref, jobs, preempt_step)
    got, got_on, eng = _run_port(arch, jobs, preempt_step, dict(eng_kw, pipeline=True))
    _guard(eng)
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ref]
    assert [r.output_tokens for r in got_on] == [r.output_tokens for r in ref_on]
    npre = sum(r.num_preemptions for r in ref)
    assert npre > 0 and sum(r.num_preemptions for r in got) == npre
    assert eng.pipeline_discards == ref_eng.pipeline_discards >= 1


def test_pipelined_mid_iteration_abort_discards_staged_batch():
    """The aborted iteration is itself a staged batch: the abort throws it
    away (commit skipped, requests stay schedulable) and stages no
    successor, so the next turn replans serially; tokens do not change."""
    cfg = get_config("llama-2-7b").reduced()
    jobs = [(40, 8)] * 3

    def go(abort_at_step):
        eng = _engine(pipeline=True)
        reqs = [_mk(cfg)(False, p, g, s) for s, (p, g) in enumerate(jobs)]
        for r in reqs:
            eng.submit(r)
        if abort_at_step is not None:
            for _ in range(abort_at_step):
                eng.step()
            assert eng._staged is not None, "pipeline never staged a batch"
            eng.arrival_poll = lambda: eng.flag.set()
            before = eng.dispatches["fused_segment"]
            eng.step()
            assert eng.safepoints.stats.preemptions == 1, "no abort happened"
            assert eng.dispatches["fused_segment"] - before < tf.num_segments(cfg), (
                "aborted iteration ran every segment")
            assert eng._staged is None, "abort path must not speculate"
            eng.arrival_poll = None
        eng.run()
        return [r.output_tokens for r in reqs]

    assert tf.num_segments(cfg) > 1, "config cannot express a mid-batch cut"
    assert go(3) == go(None), "pipelined abort changed the emitted tokens"


FAULT_SPEC = [(40, 24, s) for s in range(3)]  # offline (prompt, new tokens, seed)


def test_pipelined_engine_discards_staged_speculation_on_fault():
    """A request-scoped dispatch fault mid-decode, where the engine runs one
    staged batch ahead: the runtime rolls back, the speculation is discarded
    and counted, the victim fails, and the survivors' tokens are those of a
    fault-free pipelined run."""
    def engine(**kw):
        return _engine(slo=SLO(ttft=1.5, tpot=0.110), max_model_len=128,
                       num_device_blocks=128, pipeline=True, **kw)

    cfg = get_config("llama-2-7b").reduced()
    mk = _mk(cfg)
    clean = engine()
    ref = [mk(False, p, g, s) for p, g, s in FAULT_SPEC]
    for r in ref:
        clean.submit(r)
    clean.run()

    reqs = [mk(False, p, g, s) for p, g, s in FAULT_SPEC]
    victim = reqs[2]
    faults = FaultInjector([FaultSpec("dispatch", at=6, scope="request",
                                      request_id=victim.request_id)])
    eng = engine(faults=faults)
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-4),
                          serving=ServingConfig(health_recovery_iters=5))
    m = rt.replay(reqs)
    assert faults.injected == 1 and rt.stats.requests_failed == 1
    assert victim.phase == Phase.FAILED
    assert eng.pipeline_discards >= 1, "staged speculation was not discarded"
    assert eng._step_snap is None  # the rollback cut was consumed
    assert m.num_finished == 2
    assert all(r.phase == Phase.FINISHED for r in reqs[:2])
    assert [r.output_tokens for r in reqs[:2]] == [r.output_tokens for r in ref[:2]]
    eng.blocks.check_invariants()
    assert rt.health != RuntimeHealth.FAILED


def _run_shared(**eng_kw):
    """``test_backend_differential._run_shared``'s trace on the port: a
    32-token stem committed first, then three requests sharing 24, 32 and
    24 of its tokens (a mid-block divergence, a block-aligned prompt that
    copies on write, a second hit)."""
    eng = _engine(backend="paged", **eng_kw)
    cfg = eng.cfg
    stem = np.random.default_rng(777).integers(0, cfg.vocab_size, 32).astype(np.int32)
    reqs = []
    for seed, (plen, gen, share) in enumerate([(40, 8, 32), (40, 8, 24), (32, 8, 32),
                                               (40, 6, 24)]):
        prompt = _prompt(cfg.vocab_size, plen, 50 + seed)
        prompt[:share] = stem[:share]
        reqs.append(Request(Priority.OFFLINE, prompt_len=plen, max_new_tokens=gen,
                            prompt=prompt))
    eng.submit(reqs[0])
    for _ in range(3):
        eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run()
    return [r.output_tokens for r in reqs], eng


def test_shared_prefix_tokens_identical_pipelined():
    cold, cold_eng = _run_shared(prefix_cache=False)
    got, eng = _run_shared(pipeline=True)
    assert got == cold, "pipelined leg diverged under sharing"
    assert cold_eng.blocks.prefix_hits == 0
    assert eng.blocks.prefix_hits == 3, "trace must hit the index 3x"
    assert eng.blocks.prefix_tokens_saved == 16 + 31 + 16
    assert eng.blocks.cow_copies >= 1 and eng.cow_dispatches >= 1


def test_steady_state_keeps_one_fetch_in_flight_and_injects_pending_tokens():
    """After a steady decode step exactly one fetch is in flight (the
    iteration still on the device), and the staged batch's host-built token
    array holds placeholder zeros at its decode slots, which the injection
    fills from that fetch's device buffer."""
    eng = _engine(pipeline=True)
    built = []
    orig = eng._build_ragged
    eng._build_ragged = lambda items: built.append(orig(items)) or built[-1]
    for s in range(3):
        eng.submit(_mk(eng.cfg)(False, 20, 12, s))
    for _ in range(6):
        eng.step()
    st = eng._staged
    assert st is not None and not st.plan.prefill_chunks and len(st.plan.decode_reqs) == 3
    assert len(eng._fetches) == 1
    pending = eng._fetches[-1]
    assert [r.request_id for r in pending.reqs] == [r.request_id for r in st.plan.decode_reqs]
    host_tokens = built[-1]["tokens"]
    assert host_tokens[:3].tolist() == [0, 0, 0], "decode slots must be placeholders"
    injected = st.inputs[0][:3].tolist()
    assert injected == pending.arr[:3].tolist()
    for r in st.plan.decode_reqs:  # the values are not on the host yet
        assert len(r.output_tokens) == r.num_generated - 1
    eng.run()
    assert not eng._fetches and all(len(r.output_tokens) == 12 for r in pending.reqs)


def test_pipelined_retrace_regression_guard_mixed_onoff_drain():
    """Twin of the reference's pipelined drain guard
    (``tests/test_paged_backend.py``): the reference pins 5 fused bucket
    triples and 8 argument shapes of its two pipeline programs on this
    workload; one fused dispatch per K-layer segment per iteration, no split
    program; the host-gap counters monotone and consistent."""
    eng = _engine(backend="paged", enable_safepoints=False, pipeline=True)
    mk = _mk(eng.cfg)
    for s, (p, g) in enumerate(zip((40, 24, 40, 10, 40), (4, 6, 8, 10, 12))):
        eng.submit(mk(False, p, g, s))
    for _ in range(4):
        eng.step()
    gap_count_mid, gap_seconds_mid = eng.host_gap_count, eng.host_gap_seconds
    for s in range(3):
        eng.on_online_arrival(mk(True, 60, 8, 100 + s))
    eng.run()
    assert eng.dispatches["fused_segment"] == eng.steps * tf.num_segments(eng.cfg)
    assert eng.dispatches["fused_logits"] == eng.steps
    assert eng.dispatches["prefill"] == eng.dispatches["decode"] == 0
    assert eng.fused_trace_count == 5, eng.fused_buckets
    assert eng.pipeline_trace_count == 8, eng._pipeline_shapes
    assert eng.host_gap_count >= gap_count_mid
    assert eng.host_gap_seconds >= gap_seconds_mid
    assert eng.host_gap_count == len(eng.host_gap_s)
    assert eng.host_gap_seconds == pytest.approx(sum(eng.host_gap_s))
    assert all(g >= 0.0 for g in eng.host_gap_s)


def test_pipelined_tp2_equals_serial_tp1():
    arch, jobs, preempt_step, eng_kw = CASES[2]
    ser, ser_on, _ = _run_port(arch, jobs, preempt_step, eng_kw)
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"])
    got, got_on, eng = _run_port(arch, jobs, preempt_step,
                                 dict(eng_kw, pipeline=True, mesh=mesh))
    _guard(eng)
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ser]
    assert [r.output_tokens for r in got_on] == [r.output_tokens for r in ser_on]
    assert eng.restored_blocks > 0 and eng.pipeline_discards >= 1


def test_pipelined_calibration_enqueues_depth_iterations_per_wait():
    """A pipelined engine calibrates at depth 4 by default; each fused probe
    then runs warmup + repeats x depth dispatches (the serial engine's
    warmup + repeats)."""
    grid = CalibrationGrid(chunk_sizes=(8, 16), prefill_batches=(1, 2), decode_buckets=(1, 2),
                           ctx_fractions=(0.5,), token_buckets=(64,), warmup=1, repeats=2,
                           swap_block_counts=(1,))
    calls = {}
    for pipeline in (False, True):
        eng = _engine(pipeline=pipeline)
        assert eng._default_grid().pipeline_depth == (4 if pipeline else 1)
        n = [0]
        head = tf.ragged_lm_head

        def counted(*a, **kw):
            n[0] += 1
            return head(*a, **kw)

        tf.ragged_lm_head = counted
        try:
            prof = eng.calibrate(dataclasses.replace(
                grid, pipeline_depth=eng._default_grid().pipeline_depth))
        finally:
            tf.ragged_lm_head = head
        assert eng.sched.model is prof and all(t > 0 for _, t in prof.samples)
        calls[pipeline] = n[0]
    probes = calls[False] // (grid.warmup + grid.repeats)
    assert calls[True] == probes * (grid.warmup + grid.repeats * 4)
