"""The port's serving engine against the JAX package's, on the CPU.

``repro_torch``'s ``RealEngine(device="cpu")`` must emit the greedy tokens
of the reference's fused ``RealEngine`` on the differential cases of
``tests/test_backend_differential.py``, with the same weights, prompts and
latency model.  A top-2 logit-margin guard makes a near-tie fail loudly
instead of flipping a token silently.  Within the port, prefix cache on and
off, and preempted and uninterrupted runs, emit identical tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.profiler import TPU_V5E  # noqa: E402
from repro.core.request import Priority, Request  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, HardwareSpec  # noqa: E402
from repro_torch.core.request import Priority as PriorityT, Request as RequestT  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_backend_differential import CASES  # noqa: E402

# The two packages' fp32 logits differ by a few 1e-6 (measured on these
# reduced models); a sampled token whose top-1 minus top-2 logit is below
# this bound could flip between them, so such a case fails as a near-tie.
MARGIN_BOUND = 2e-5


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = get_config(arch).reduced()
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompt(vocab, plen, seed):
    return np.random.default_rng(seed).integers(0, vocab, plen).astype(np.int32)


def _drive(eng, mk, jobs, preempt_step):
    reqs = [mk(False, plen, gen, seed) for seed, (plen, gen) in enumerate(jobs)]
    for r in reqs:
        eng.submit(r)
    online = []
    if preempt_step is not None:
        for _ in range(preempt_step):
            eng.step()
        for s in range(2):
            online.append(mk(True, 60, 8, 100 + s))
            eng.on_online_arrival(online[-1])
    eng.run()
    return reqs, online


def _run_reference(arch, jobs, preempt_step, eng_kw):
    cfg, params, _ = _weights(arch)
    eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(**eng_kw))

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    return _drive(eng, mk, jobs, preempt_step)


def _run_port(arch, jobs, preempt_step, eng_kw):
    cfg = get_config_t(arch).reduced()
    eng = engine_t.RealEngine(
        cfg, bridge.to_torch(_weights(arch)[2]),
        eng_cfg=engine_t.RealEngineConfig(**eng_kw), device="cpu",
    )
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(cfg, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    eng.margins = {}

    def mk(on, plen, gen, seed):
        return RequestT(PriorityT.ONLINE if on else PriorityT.OFFLINE, prompt_len=plen,
                        max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, jobs, preempt_step)
    return reqs, online, eng


@pytest.mark.parametrize("arch,jobs,preempt_step,eng_kw", CASES)
def test_port_emits_reference_tokens(arch, jobs, preempt_step, eng_kw):
    ref, ref_on = _run_reference(arch, jobs, preempt_step, eng_kw)
    got, got_on, eng = _run_port(arch, jobs, preempt_step, eng_kw)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= "
        f"{MARGIN_BOUND}, so token identity with the reference is not meaningful"
    )
    assert [len(r.output_tokens) for r in got] == [g for _, g in jobs]
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ref]
    assert [r.output_tokens for r in got_on] == [r.output_tokens for r in ref_on]
    npre = sum(r.num_preemptions for r in ref)
    assert sum(r.num_preemptions for r in got) == npre
    if preempt_step is not None:
        assert npre > 0, "preemption scenario did not preempt"
        assert eng.restored_blocks > 0 and eng.ckpt_gathers > 0
    assert eng.dispatches["fused_segment"] > 0
    assert 0 < eng.fused_trace_count == len(eng.fused_buckets)


def _serve(*extra):
    args = serve.build_parser().parse_args(
        "--device cpu --dtype float32 --online 4 --offline 8 --prompt-len 512 "
        "--max-new 48 --online-after 4".split() + list(extra)
    )
    res = serve.run_real(args)
    reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
    return res, [r.output_tokens for r in reqs]


def test_port_legs_emit_identical_tokens():
    """Serving through ``launch.serve.run_real``: a pool small enough that
    the online arrivals preempt offline work (checkpoint gathers, resume
    restores) emits the same tokens as an uninterrupted run, with the
    prefix cache on or off; every request gets all its tokens."""
    pre, toks = _serve("--num-device-blocks", "56")
    eng = pre["engine"]
    assert pre["preemptions"] > 0 and eng.ckpt_gathers > 0 and eng.restored_blocks > 0
    assert all(len(t) == 48 for t in toks)
    assert pre["job"].done and all(h.finished for h in pre["streams"])
    calm, calm_toks = _serve("--num-device-blocks", "512")
    assert calm["preemptions"] == 0
    _, cold_toks = _serve("--num-device-blocks", "56", "--no-prefix-cache")
    assert toks == calm_toks == cold_toks


def test_resumed_work_never_lands_in_the_scratch_block():
    """Regression: a resumed request's recompute chunk (or decode slot) can
    reach past the blocks ``resume()`` re-allocates; the port's scheduler
    grows them first, so no real token reads or writes the scratch block."""
    hits = []
    orig = engine_t.RealEngine._build_ragged

    def checked(self, items):
        for qlen, ctx, _toks, table in items:
            need = -(-(ctx + qlen) // self.ec.block_size)
            hits.extend(table[:need][table[:need] == self._scratch_block])
        return orig(self, items)

    engine_t.RealEngine._build_ragged = checked
    try:
        res, toks = _serve("--num-device-blocks", "56")
    finally:
        engine_t.RealEngine._build_ragged = orig
    assert res["preemptions"] > 0 and not hits


def test_engine_refuses_what_is_not_ported():
    cfg = get_config_t("llama-2-7b").reduced()
    params = bridge.to_torch(_weights("llama-2-7b")[2])
    windowed = dataclasses.replace(cfg, sliding_window=8)  # a ring cache
    for c, kw, item in [(cfg, dict(pipeline=True), "Queue 1: the async pipeline"),
                        (cfg, dict(mesh=object()), "Queue 1: tensor parallelism"),
                        (windowed, dict(backend="contiguous"),
                         "Queue 1: the contiguous fallback's other archs")]:
        with pytest.raises(NotImplementedError, match=item):
            engine_t.RealEngine(c, params, eng_cfg=engine_t.RealEngineConfig(**kw),
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            engine_t.RealEngine(cfg, params)  # the default device is cuda


def test_request_scoped_fault_rolls_back_and_survivors_are_exact():
    """The dispatch fault point (DESIGN.md §16): a request-scoped fault
    raised before any device work rolls the iteration back; failing that
    one request leaves the others' tokens as in a fault-free run."""
    from repro_torch.core.faults import FaultInjector, FaultSpec, RequestFailed

    jobs = [(40, 8)] * 3
    clean, _, _ = _run_port("llama-2-7b", jobs, None, {})
    cfg = get_config_t("llama-2-7b").reduced()
    eng = engine_t.RealEngine(
        cfg, bridge.to_torch(_weights("llama-2-7b")[2]), device="cpu",
        eng_cfg=engine_t.RealEngineConfig(
            faults=FaultInjector([FaultSpec("dispatch", at=3, scope="request")])),
    )
    reqs = [RequestT(PriorityT.OFFLINE, prompt_len=p, max_new_tokens=g,
                     prompt=_prompt(cfg.vocab_size, p, seed))
            for seed, (p, g) in enumerate(jobs)]
    for r in reqs:
        eng.submit(r)
    failed = []
    for _ in range(200):
        try:
            if not eng.step():
                break
        except RequestFailed as e:
            eng.recover_from_fault()
            victim = next(r for r in reqs if r.request_id == e.request_id)
            eng.fail_request(victim)
            failed.append(victim)
    assert len(failed) == 1
    for r, c in zip(reqs, clean):
        if r is not failed[0]:
            assert r.output_tokens == c.output_tokens
